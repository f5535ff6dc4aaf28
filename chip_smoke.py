"""Smoke run of word2bits_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from
word2bits_tpu_torch/csrc/ (one nvcc per source, all at once; [ptxas]
prints each kernel's registers, shared memory and spills, and kernels 1,
2, 3, 5, 6, 7, 8 and 9, the banded u-sum, the subword gather-mean and
the position-weighted context must not spill), holds each against its
plain PyTorch version at the shapes of the paths that run it ([band
usum@800] and [band usum@200] at the CBOW cells', [subword] kernel 11 at
the fasttext cell's (its 2,519,371 spelled words' subword rows built on
the card, 8,192 centers), [pos_context] kernel 12 at the ftcbow cell's
(B 8,192, W 5, D 300, the step's masks), [context], [span]
and [grmw] each printing a digest of the table it wrote, to hold kernels 2
and 7 bit-equal across commits, and each the same kernel on the fused
step's rows read from their three parts, bit-equal to it on them
materialized, both timed, [score], [score edges] ragged tiles at
bitlevels 0/1/2/4/8, [rank1] with kernel 2 on its float32 table, [hotk],
[hot edges] kernel 6 at its tiles' edges with and without `extra`, [grmw],
[grmw edges] kernel 7 at its tiles' edges in three dtype pairs at widths
37, 200 and 1,600, [rmwk], [rmw edges] kernel 8 at its tiles' edges and
on an id whose rounded sum differs from the sum of its rounded pieces,
[context@800], [context@exact] on float32 rows, [context@mask] on
non-banded random masks, [quantk] kernel 4 at the capacity export's
block, on a bf16 table and on the whole 3.7M x 800 sum, [sweepk] kernel
9 at kernel 2's shape, [sweepk edges] on a plan whose head id spans
four blocks, [spank edges]: kernels 2 and 3 on one id holding
102,400 rows, runs about the tile length, sentinels only and N = 0, in
three dtype pairs at four widths, bit-equal to each other and from
launch to launch, and [span paths]: kernel 2 through ops/scatter.
scatter_add at the `add` routes' shapes (the per-pair skip-gram step's
at 692,001 x 300 among them), with one scatter timed through
`index_add_` and through the sort and kernel 2), checks
the steps and chunks of both engines on the card against the same code on
the CPU ([step], the fused chunk's "sweep" scatter among them), and then
drives the port's paths through their entry points, each with the
kernels' launch counts set to 0 just before and read just after:

  [train]       the shipped throughput configuration (the JAX package's
                bench.py CFG plus ctx_span_banded256_S256: size 200, span
                scatter) through `cli train`, one epoch of a 17M-token
                corpus, built on the card (the auto -device-epoch);
  [flagship]    the full-Wikipedia capacity configuration of
                docs/large_vocab.md:19-25 (V = 3,699,941, size 800,
                B = 16384, grmw scatter, -loop-mode fori, -packed 1)
                through `train.train`, 64 steps with -checkpoint-dir,
                then its `.pack` export (kernel 4 once per 20,971-row
                block, 177 times) and its checkpoint read back, and the
                export timed again with the plain quantize;
  [resume]      that checkpoint resumed with -resume 1 for 32 steps of
                epoch 1 (no -output), peak device memory against the
                table;
  [accuracy]    `cli accuracy` on that `.pack` and on [train]'s vector
                file, each transcript checked against the CPU evaluator;
  [quickstart]  the README Quick start's flags (the reference-default
                split-table engine: per-center negatives, B = 256, shifted
                sums, `add` scatter, float32) through `train.train` on
                [train]'s corpus, cut to 4,096 steps, its vectors read back;
  [determinism] same seed, same tables: (a) one step of every [step]
                configuration, of skip-gram and of the 2 x 2 LocalMesh
                bodies under utils/audit.ScatterAudit, no accumulating
                scatter (index_add_, scatter_add_, ...) on a CUDA tensor;
                (b) each [step] chunk twice from one state, and the Quick
                start, -use-pallas, -hot-rows 2048 (no kernel 6), its
                stratified and dense-hot strata, skip-gram, the block
                dedup on both engines and the 2 x 2 mesh `add` route at
                full width twice from one generator seed: bit-equal tables
                and equal losses, and other tables from another seed; (c)
                the Quick start through train.train at -seed 1 twice (the
                vector files byte-equal) and at -seed 2 (different);
  [exact]       per-center at the JAX package's exact-mode throughput
                flags (B = 4096, 128-step chunks, banded 256, span scatter,
                context kernel): one chunk with materialized negative rows
                and one with the rank-1 span scatter, same state and draws;
  [pallas]      the shipped flags with `-scatter-impl add -use-pallas 1`,
                one 256-step chunk on the fused and one on the split tables;
  [hot]         the shipped flags with `-scatter-impl add -hot-rows 2048
                -hot-pallas 1` (the hot/cold split through kernel 6), two
                256-step chunks through train.train, its vectors read back;
                then one chunk each with `-neg-stratify 1`, with
                `-neg-dense-hot 1 -device-epoch 0`, and with `-neg-dense-hot
                1` under the auto -device-epoch (kernel 6 launched 0 times,
                as in the JAX package: no cold map there);
  [flagship run] the port's flagship tool (word2bits_tpu_torch/tools/
                flagship_run.py) at full width (3.7M words, size 800,
                B = 16384) and reduced depth (8M tokens in segments of
                2^22 tokens): leg 1 trains one epoch and checkpoints, leg 2
                resumes for a second and exports (kernel 4 once per block),
                the vectors read back as +-1/3 and the analogy evaluation
                over every row; kernels 1 and 7 once per step of each leg
                (both held against their plain versions at its window 5
                and 10 negatives first), leg 2 going on from leg 1's
                table by its losses, peak device memory <= 1.25 x the
                table in both; no cross-check (the reference's source is
                not in the repository);
  [rmw]         the capacity configuration with `-rmw-scatter 1
                -steps-per-chunk 1` (docs/large_vocab.md:34), 16 steps,
                kernel 8 twice a step, peak device memory against the table;
  [mesh]        the (data, vocab) mesh trainer (parallel/): (a) the
                shipped flags on split tables (no context kernel, which is
                single-chip) through `cli train -mesh-shape
                data=1,vocab=1`, a one-rank NCCL group, one epoch of
                [train]'s corpus, kernel 2 twice a step on the shard's
                local ids; (b) after [quickstart], LocalMesh 2 x 2 and
                1 x 4 (every shard in this process) at those widths, a
                256-step bf16 chunk held by its loss to the single-device
                chunk on the same draws and every step of it held from the
                single device's state in float32 and bf16, kernel 2's time
                on one shard beside the single card's; (c) after [rmw],
                the capacity form with -mesh-shape vocab=1, 16 steps,
                kernel 8 twice a step, peak device memory against the
                table; (d) LocalMesh vocab=4 at the capacity width against
                (c)'s chunk over 8 steps, kernel 8's time on one shard;
  [native]      the C++ tokenizer built with g++ (use_native=True: a failed
                build fails the run), [train]'s corpus counted and encoded
                and the flagship's alias table built both ways, equal;
  [device epoch] the card's epoch build bit-equal to the host's on the
                same float32 uniforms, on the flagship's corpus and (after
                [quickstart]) on [train]'s, each timed both ways;
  [sweep]       one 256-step fused chunk at the shipped flags with
                scatter_impl="sweep" (kernel 9; the config rejects the
                flag, as the JAX package's does), against the same chunk
                with "span";
  [skipgram]    the skip-gram step and chunk card vs CPU (per-center,
                shared, dense-hot and per pair), then the Quick
                start's flags with -model skipgram for 2,048 steps, and
                with -hot-rows 2048 -neg-dense-hot 1 on bf16, vectors
                written (kernel 4) and read back;
  [tune]        `cli tune -tune-seconds 2 -json 1` on [train]'s corpus at
                the shipped flags with -scatter-impl add: every variant
                measured, kernels 1, 2 and 6 launched;
  [profile]     one chunk of the shipped flags with -profile-dir, the
                Chrome trace naming kernels 1 and 2;
  [parity]      per-center bitlevel 0 and skip-gram bitlevel 1 on the
                30,000-sentence structured corpus, each analogy accuracy
                at or above the JAX package's mean - 3 sd;
  [convert]     `cli convert` of a seeded 70,000 x 200 float32 file at
                three flag sets, card against W2B_FORCE_CPU=1, the files
                byte-identical; [nearest] `cli nearest` of 20 words at
                bitlevels 1 and 0, the transcripts equal apart from ties;
  [fasttext]    fastText's subword skip-gram at the fasttext cell's flags
                (2M buckets x 300, n-grams 3-6, NEG-5 a pair) through the
                CLI's parser and train.train, one epoch of a 4M-token
                corpus over 400,000 spelled words: kernel 11 once a step
                and once an export block, the vectors the mean of each
                word's quantized rows.
  [ftcbow]      fastText CBOW with position weights at the ftcbow cell's
                flags (2M buckets x 300, 5-grams, window 5, NEG-10 a
                center) through the CLI's parser and train.train, one
                epoch of a 2M-token corpus over 200,000 spelled words:
                kernel 12 twice a step, kernel 11 once a step and once an
                export block, d [10, 300] trained and not exported.

Peak disk is about 24 GB, in [flagship] and again in [flagship run]: the
11.84 GB checkpoint, the 11.9 GB vector file and the 0.4 GB `.pack` (all
in .smoke_work/, removed at the end of each).

Any failed check raises, so the exit code is nonzero; without a CUDA card
(or outside a checkout) it exits nonzero before printing any result.

Output: the card's name and power limit (nvidia-smi), one line per phase,
then one JSON line {"kernels": [...]} with each kernel's launches on the
training paths, its max error against the plain version, its time, the
plain version's time, its bound, and the one-call library yardstick; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import re
import resource
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# The shipped configuration (the JAX package's bench.py CFG plus its
# ctx_span_banded256_S256 variant), as `cli train` flags.
B, W, D, K, G, P, TILE, S = 8192, 8, 200, 24, 64, 2, 256, 256
TRAIN_FLAGS = [
    "-bitlevel", "1", "-size", str(D), "-window", str(W),
    "-negative", str(K), "-min-count", "5", "-sample", "1e-3",
    "-alpha", "0.1", "-batch-size", str(B), "-steps-per-chunk", str(S),
    "-fused-tables", "1", "-neg-sharing", str(G), "-neg-pool", str(P),
    "-dtype", "bfloat16", "-banded-tile", str(TILE),
    "-scatter-impl", "span", "-context-pallas", "1",
    "-iter", "1", "-binary", "1", "-debug", "1", "-seed", "1",
]
# text8-like synthetic corpus: ~70k types survive -min-count 5
CORPUS_TOKENS, CORPUS_TYPES = 17_000_000, 70_000
# the span scatter at the main path: table [V, 2D], B+2W slab rows plus
# (B/G) * P*K negative rows per step
SCATTER_V, SCATTER_N = 70_000, B + 2 * W + (B // G) * P * K

# The capacity configuration, docs/large_vocab.md:19-25, as written there.
FLAGSHIP_FLAGS = [
    "-output", "1b800d_full.pack", "-packed", "1",
    "-size", "800", "-window", "8", "-negative", "24", "-iter", "5",
    "-min-count", "5", "-bitlevel", "1",
    "-dtype", "bfloat16", "-fused-tables", "1", "-neg-sharing", "64",
    "-batch-size", "16384", "-steps-per-chunk", "32", "-loop-mode", "fori",
    "-scatter-impl", "grmw", "-banded-tile", "256", "-context-pallas", "1",
]
FLAG_V, FLAG_D, FLAG_B = 3_699_941, 800, 16384
FLAG_STEPS = 64                  # two 32-step chunks
# The README Quick start (all else default: the split-table slab engine
# with per-center negatives, B = 256, shifted sums, `add`, float32), cut to
# QS_STEPS steps of the 17M-token corpus (one epoch is ~47,000 steps).
QUICKSTART_FLAGS = ["-size", str(D), "-window", str(W), "-negative", str(K),
                    "-min-count", "5", "-bitlevel", "1", "-binary", "1"]
QS_STEPS = 4096
# The per-center exact mode at the JAX package's measured throughput flags
# (tools/step_bench.py:200-218), f32 tables.
EXACT_FLAGS = QUICKSTART_FLAGS + [
    "-batch-size", "4096", "-steps-per-chunk", "128", "-banded-tile", "256",
    "-scatter-impl", "span", "-context-pallas", "1"]
EXACT_B, EXACT_S = 4096, 128
# the shipped flags with the fused score kernel (its configuration needs
# the `add` scatter), on the fused and the split tables
PALLAS_FLAGS = list(TRAIN_FLAGS)
PALLAS_FLAGS[PALLAS_FLAGS.index("-scatter-impl") + 1] = "add"
ADD_FLAGS = list(PALLAS_FLAGS)
PALLAS_FLAGS += ["-use-pallas", "1"]
# the hot/cold split at the shipped flags: H = cli tune's own choice at
# V ~ 70k, max(256, min(2048, V // 8)) (the JAX package's tune.py:80-81)
HOT = 2048
HOT_FLAGS = ADD_FLAGS + ["-hot-rows", str(HOT), "-hot-pallas", "1"]
HOT_STEPS = 2 * S                # two 256-step chunks
# the earlier capacity path (docs/large_vocab.md:34): the capacity flags
# with -rmw-scatter 1 -steps-per-chunk 1 in place of -scatter-impl grmw
# -loop-mode fori -steps-per-chunk 32 (no export: [flagship] writes it)
RMW_FLAGS = [f for f in FLAGSHIP_FLAGS[4:]
             if f not in ("-scatter-impl", "grmw", "-loop-mode", "fori")]
RMW_FLAGS[RMW_FLAGS.index("-steps-per-chunk") + 1] = "1"
RMW_FLAGS += ["-rmw-scatter", "1"]
RMW_STEPS = 16
# kernel 8's two calls a step at the capacity shape: the B+2W slab rows,
# then the (B/64) * 24 negative rows (one pool)
RMW_N = (FLAG_B + 2 * W, (FLAG_B // 64) * 24)
# kernel 5 at the shipped shape: T = B/G tiles of G centers, P*K negatives
SCORE_T, SCORE_PK = B // G, P * K
# kernel 3 at the exact-mode shape: 4,096 center rows, 4,096 * 24 rank-1
RANK1_V, RANK1_ND = 69_998, 4096
F32_FLOP_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
# one flagship step's update rows: B+2W slab rows plus (B/64) * 24
# negatives (one pool)
FLAG_N = FLAG_B + 2 * W + (FLAG_B // 64) * 24
# Zipf(1.05) head of the synthetic vocabulary: count(r) = max(5, C r^-1.05)
FLAG_ZIPF_C = 700_000
ACC_THRESHOLD = 1_000_000        # rows of the .pack the evaluator reads
ACC_QUESTIONS = 1200

# kernel 4 at the export's block: 2^24 // 800 = 20,971 rows of the float32
# u + v sum, 177 blocks over the capacity table; and a bf16 table
EXPORT_ROWS = (1 << 24) // FLAG_D
EXPORT_BLOCKS = -(-FLAG_V // EXPORT_ROWS)
# [convert]/[nearest]: a seeded 70,000 x 200 float32 binary vector file
CONVERT_V, CONVERT_D = 70_000, 200
CONVERT_CASES = (["-bitlevel", "1", "-packed", "1"],
                 ["-bitlevel", "4", "-binary", "1"],
                 ["-bitlevel", "2"])
NEAREST_QUERIES = 20
RESUME_STEPS = 32                # [resume]: one 32-step chunk of epoch 1
# [flagship run]: the port's flagship tool at the capacity width, its
# depth cut from 60M tokens in 2^24-token segments, 2 + 1 epochs, to 8M
# tokens (the Zipf tail alone names 3.7M words) in 2^22-token segments,
# 1 + 1 epochs
FLAGSHIP_RUN_ARGS = ["--vocab", "3700000", "--size", str(FLAG_D),
                     "--batch", str(FLAG_B), "--tokens", "8000000",
                     "--segment", str(1 << 22), "--epochs", "1",
                     "--skip-crosscheck"]
# [skipgram]: the Quick start's flags with -model skipgram, cut to 2,048
# steps (eight 256-step chunks) of [quickstart]'s corpus
SG_FLAGS = ["-model", "skipgram"]
SG_STEPS = 2048
# [tune]: the shipped flags with -scatter-impl add, where every overlay of
# tune.variants validates (at -scatter-impl span the hot-rows and dense-hot
# overlays fail the config's check in both packages: span does not compose
# with -hot-rows); its span-banded and ctx-span-banded variants run
# kernels 1 and 2, hot-rows kernel 6
TUNE_FLAGS = list(ADD_FLAGS)
# [parity]: (floor, mean, sd) of the JAX package's analogy accuracy on the
# 30,000-sentence structured corpus, 5 epochs, seeds 1-5, on the CPU
# (tests/test_torch_parity.py --jax-floors); the floor is mean - 3 sd
PARITY_FLOORS = {"per-center-b0": (70.04, 76.68, 2.2118),
                 "skipgram-b1": (52.93, 61.60, 2.8914)}

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
SEED = 0
# log(sigmoid_exact) jumps at the saturation edges: -6 (log 1e-9 vs
# log sigma(-6)) and +6 (log 1 vs log sigma(6))
_JUMP_LO = math.log(1.0 / (1.0 + math.exp(6.0))) - math.log(1e-9)
_JUMP_HI = -math.log(1.0 / (1.0 + math.exp(-6.0)))


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches: CUDA events around
    launches queued behind a sleep kernel, so that the host's time to issue
    them (a wrapper's checks, a plain version's many small launches) leaves
    no gap on the card.  The sleep grows until the launches were all queued
    before it ended; a function that waits for the card itself (kernel 9's
    plain version reads run lengths back) is timed as the host paces it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000           # ~10 ms at the H100's clock
    while True:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued = not start.query()    # the sleep still ran: no gaps
        torch.cuda.synchronize()
        if queued or cycles >= 320_000_000:
            return start.elapsed_time(stop) / reps
        cycles *= 4


def _host_us(fn, reps: int = 100, warmup: int = 5) -> float:
    """Mean host time to issue fn() once, in µs: reps calls after a
    synchronise and no synchronise among them (a hundred calls of a few
    launches each stay inside the card's launch queue)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _proc_status(key: str) -> int:
    """A "Vm..." field of /proc/self/status, in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise KeyError(key)


class _RssPeak:
    """The peak of this process's RSS while the block runs, sampled every
    20 ms from /proc/self/status by a thread."""

    def __enter__(self) -> "_RssPeak":
        self.peak, self._stop = 0, threading.Event()

        def sample():
            while True:
                self.peak = max(self.peak, _proc_status("VmRSS"))
                if self._stop.wait(0.02):
                    return

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *_) -> None:
        self._stop.set()
        self._thread.join()


def _step_ids(rng, V: int, n_slab: int, n_neg: int,
              n_sentinel: int) -> np.ndarray:
    """One training step's scatter ids on a Zipf(1.05) corpus over V
    words: n_slab slab ids from the subsampled (-sample 1e-3) unigram,
    n_neg negatives from unigram^0.75, n_sentinel drop sentinels."""
    from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
    p = np.arange(1, V + 1, dtype=np.float64) ** -1.05
    p /= p.sum()
    p_kept = p * np.minimum((np.sqrt(p / 1e-3) + 1.0) * 1e-3 / p, 1.0)
    p_neg = p ** 0.75
    ids = np.concatenate([rng.choice(V, n_slab, p=p_kept / p_kept.sum()),
                          rng.choice(V, n_neg, p=p_neg / p_neg.sum())])
    ids[rng.choice(ids.size, n_sentinel, replace=False)] = SENTINEL
    return ids.astype(np.int64)


class _Tee(io.TextIOBase):
    """A stream writing to several: the phase's log shown and kept."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


# ---------------------------------------------------------------- kernel 1
def _hold_context(args, b: int, tag: str, bitlevels=(0, 1, 2, 4, 8)) -> float:
    """fused_context_pallas against fused_context_plain on `args` at each
    bitlevel; the worst output error over every center.

    Both compute each center's score f = cavg . quantize(v_center) in
    float32 in another order, and three functions of f are discontinuous:
    the LUT sigmoid at its bin edges ((f+6)*83 an integer) and
    sigmoid_exact at +-6.  A center whose plain f lies within 0.005 of a LUT
    bin edge (6e-5 in f) or within 6e-5 of +-6 may take the other side in
    the kernel.  At bitlevel 1 many lie on an edge exactly: f is then a
    multiple of 1/(9 n) for a center of n context rows, and 1/(9 b') of
    the centers of window b' score on an edge (~4% at window 8, ~5% at 5).
    So every center's cavg and af are held to the plain version's, and its
    two products of the LUT gradient (cavge, dv_center) to the plain
    version's, or, for a center at an edge, to the plain formula at f -
    1e-4 or f + 1e-4, one on each side of the edge; at most 5% of the
    centers may take the other side.  The loss may move by the jump of
    log(sigmoid_exact) at the edge for each center at +-6.  The edges are
    found from the plain version's f alone.  Outputs atol 1e-4 + rtol
    1e-4, loss rtol 1e-5."""
    from word2bits_tpu_torch.kernels.context_pallas import (
        fused_context_pallas, fused_context_plain)
    from word2bits_tpu_torch.ops.quantize import quantize
    from word2bits_tpu_torch.ops.sigmoid import sigmoid_lut
    uwin3, vc, Mb, validf, alpha = args
    worst = 0.0

    def close(g, w):                     # per center
        ok = (g - w).abs() <= 1e-4 + 1e-4 * w.abs()
        return ok if ok.dim() == 1 else ok.all(dim=1)

    for bl in bitlevels:
        got = fused_context_pallas(uwin3, vc, Mb, validf, alpha, bl)
        want = fused_context_plain(uwin3, vc, Mb, validf, alpha, bl)
        torch.cuda.synchronize()
        q_vc = quantize(vc.float(), bl)
        f = (want[0] * q_vc).sum(dim=1)
        x = (f + 6.0) * 83.0
        lut_edge = ((x - x.round()).abs() < 0.005) & (f.abs() <= 6.0)
        lo, hi = (f + 6.0).abs() < 6e-5, (f - 6.0).abs() < 6e-5
        edge = lut_edge | lo | hi
        n_edge = int(edge.sum())
        for name, k in (("cavg", 0), ("af", 3)):
            if not close(got[k], want[k]).all():
                _fail(f"[{tag}] context kernel {name} at bitlevel {bl}: max "
                      f"abs err {_max_err(got[k], want[k]):.3e} > atol 1e-4 "
                      "+ rtol 1e-4")
        # each center's error in its two LUT-gradient products against the
        # plain version, or, at an edge, against the side nearest to it
        def err(a1, a2):
            return torch.maximum((got[1] - a1).abs().amax(dim=1),
                                 (got[2] - a2).abs().amax(dim=1))

        best = err(want[1], want[2])
        ok = close(got[1], want[1]) & close(got[2], want[2])
        other = torch.zeros_like(ok)     # took the other side of its edge
        for df in (-1e-4, 1e-4):         # the plain formula across the edge
            g = (1.0 - sigmoid_lut(f + df)) * alpha.reshape(()) * want[3]
            a1, a2 = g[:, None] * q_vc, g[:, None] * want[0]
            e = err(a1, a2)
            side = edge & close(got[1], a1) & close(got[2], a2)
            nearer = side & (e < best)
            best = torch.where(nearer, e, best)
            ok |= side
            other |= nearer
        if not ok.all():
            bad = ~ok
            _fail(f"[{tag}] context kernel cavge/dv_center at bitlevel {bl}: "
                  f"{int(bad.sum())} centers ({int((bad & edge).sum())} at a "
                  "score edge) off the plain version on either side by more "
                  "than atol 1e-4 + rtol 1e-4")
        n_other = int(other.sum())
        if n_other > 0.05 * b:
            _fail(f"[{tag}] context kernel at bitlevel {bl}: {n_other} "
                  "centers took the other side of a score edge (more than "
                  "5%)")
        errs = [_max_err(got[0], want[0]), _max_err(got[3], want[3]),
                float(best.max())]
        worst = max(worst, *errs)
        lg, lw = float(got[4]), float(want[4])
        allow = (1e-5 * abs(lw) + _JUMP_LO * int(lo.sum())
                 + _JUMP_HI * int(hi.sum()))
        if not math.isfinite(lg) or abs(lg - lw) > allow:
            _fail(f"[{tag}] context kernel loss at bitlevel {bl}: {lg} vs "
                  f"{lw} (allowed {allow:.4g})")
        print(f"[{tag}] bitlevel {bl}: max abs err {max(errs):.3e} over all "
              f"{b} centers ({n_edge} at a score edge, "
              f"{int(lo.sum() + hi.sum())} of them at +-6; {n_other} took "
              f"the other side), loss {lg:.6f} vs plain {lw:.6f}")
    return worst


def _context_inputs(dev, b: int, d: int, dtype: torch.dtype, mask: str,
                    w: int = W):
    """Kernel 1's inputs at B = b, D = d, window w, tile 256, in both forms:
    ((uwin3, vc, Mb, validf, alpha), (u_tab, v_tab, slab_ids)).  A seeded
    table of 4 (b + 2w) rows (bf16: one fused [V, 2d] table, u and v its
    halves; float32: split [V, d] tables), slab ids drawn from it with the
    padding positions at id 0 (the step's clamp of -1), and the dense rows
    gathered and copied from it as the fused step did; sentences of ~20
    tokens (a few padding positions at the end), and the banded masks of
    random shrinks; or, with mask="random", a non-banded 0/1 mask with
    ~30% ones over all F = 256 + 2w columns and every 37th row empty, whose
    span is wider than one staged piece."""
    from word2bits_tpu_torch.ops.windowed import (_tile_windows,
                                                  build_banded_masks)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Nt, n = b // TILE, b + 2 * w
    table = (torch.randn((4 * n, 2 * d), generator=gen, device=dev)
             * 0.3).to(dtype)
    ids = torch.randint(0, 4 * n, (n,), generator=gen, device=dev)
    sents = torch.arange(n, device=dev) // 20
    sents[-5:] = -1
    ids[-5:] = 0
    shrink = torch.randint(0, w, (b,), generator=gen, device=dev)
    Mb, _, valid = build_banded_masks(sents, shrink, b, w, TILE)
    if mask == "random":
        Mb = (torch.rand(Mb.shape, generator=gen, device=dev) < 0.3).to(
            torch.float32)
        Mb.view(b, -1)[::37] = 0.0
    slab = table[ids]
    uwin3 = _tile_windows(slab[:, :d], Nt, TILE, w).contiguous()
    vc = slab[w:w + b, d:].contiguous()
    validf = valid.to(torch.float32)[:, None].contiguous()
    alpha = torch.full((1, 1), 0.1, device=dev)
    if dtype == torch.bfloat16:
        tabs = (table[:, :d], table[:, d:])
    else:
        tabs = (table[:, :d].contiguous(), table[:, d:].contiguous())
    return (uwin3, vc, Mb, validf, alpha), (*tabs, ids)


def _hold_rows(args, rows, tag: str, bitlevels=(0, 1, 2, 4, 8)) -> None:
    """fused_context_rows (the rows read from their tables by id) against
    fused_context_pallas on the same rows materialized: every output bit
    for bit, each call counted by both wrappers."""
    from word2bits_tpu_torch.kernels.context_pallas import (
        fused_context_pallas, fused_context_rows)
    uwin3, vc, Mb, validf, alpha = args
    for bl in bitlevels:
        before = (fused_context_pallas.launches, fused_context_rows.launches)
        got = fused_context_rows(*rows, Mb, validf, alpha, bl)
        want = fused_context_pallas(uwin3, vc, Mb, validf, alpha, bl)
        torch.cuda.synchronize()
        for name, g, x in zip(("cavg", "cavge", "dv_center", "af", "loss"),
                              got, want):
            if not torch.equal(g.view(torch.int32), x.view(torch.int32)):
                _fail(f"[{tag}] kernel 1 by id: {name} at bitlevel {bl} "
                      "differs from the dense call's (max abs err "
                      f"{_max_err(g, x):.3e})")
        if (fused_context_pallas.launches - before[0],
                fused_context_rows.launches - before[1]) != (2, 1):
            _fail(f"[{tag}] kernel 1 by id: launches counted "
                  f"{fused_context_pallas.launches - before[0]} and "
                  f"{fused_context_rows.launches - before[1]} (2 and 1 "
                  "expected)")
    print(f"[{tag}] by id: every output bit-equal to the dense call at "
          f"bitlevels {'/'.join(map(str, bitlevels))}")


def context_launch_shape(b: int, d: int, dtype: torch.dtype,
                         w: int = W) -> str:
    """Kernel 1's launch at B = b, D = d, window w, tile 256 (its C
    report)."""
    import ctypes
    from word2bits_tpu_torch.kernels.context_pallas import _library
    out = (ctypes.c_int * 4)()
    fn = _library().w2b_context_launch_shape
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    F = TILE + 2 * w
    if fn(F, d, TILE, 1 if dtype == torch.bfloat16 else 0,
          ctypes.addressof(out)):
        _fail(f"kernel 1 refuses D = {d}")
    grid = (TILE // 16) * (b // TILE)
    return (f"{grid} CTAs of {out[0]} threads, {out[1]} bytes of dynamic "
            f"shared memory, {out[2]} window rows a piece, {out[3]} centers "
            "a thread")


def check_context(dev, b: int, d: int, tag: str,
                  dtype: torch.dtype = torch.bfloat16, w: int = W) -> dict:
    """fused_context_pallas against fused_context_plain on the card at
    B = b, D = d, window w, tile 256, bitlevels 0/1/2/4/8, table rows of
    `dtype` (bf16 on the fused engines, float32 on the split tables), with
    the edge rule of _hold_context; fused_context_rows bit-equal to it
    (_hold_rows); then, at bitlevel 1, both timed beside the plain version
    and the dense call with the gather and copies that fed it (`gather_ms`:
    the rows gathered from the table, the tile windows and center rows
    copied, the kernel)."""
    from word2bits_tpu_torch.kernels.context_pallas import (
        fused_context_pallas, fused_context_plain, fused_context_rows)
    from word2bits_tpu_torch.ops.windowed import _tile_windows
    args, rows = _context_inputs(dev, b, d, dtype, "banded", w)
    print(f"[{tag}] launch: {context_launch_shape(b, d, dtype, w)}")
    worst = _hold_context(args, b, tag)
    _hold_rows(args, rows, tag)
    uwin3, vc, Mb, validf, alpha = args
    u_tab, v_tab, ids = rows
    args = (uwin3, vc, Mb, validf, alpha, 1)
    ms = _time_ms(lambda: fused_context_pallas(*args))
    rows_ms = _time_ms(lambda: fused_context_rows(*rows, *args[2:]))

    def gathered():
        u_rows, v_rows = u_tab[ids], v_tab[ids[w:w + b]]
        fused_context_pallas(
            _tile_windows(u_rows, b // TILE, TILE, w).contiguous(),
            v_rows.contiguous(), *args[2:])

    gather_ms = _time_ms(gathered)
    plain_ms = _time_ms(lambda: fused_context_plain(*args))
    # bytes: each input read once, each output written once
    nbytes = sum(t.numel() * t.element_size()
                 for t in (uwin3, vc, Mb, validf, alpha))
    nbytes += 3 * b * d * 4 + b * 4 + 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] bitlevel 1 kernel {ms:.5f} ms, by id {rows_ms:.5f} ms, "
          f"gather + copies + kernel {gather_ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({nbytes} bytes)")
    return dict(name="fused_context_pallas", route="cuda",
                source="word2bits_tpu_torch/csrc/context.cu",
                replaces="word2bits_tpu/kernels/context_pallas.py:82",
                max_abs_err=worst, ms=ms, rows_ms=rows_ms,
                gather_ms=gather_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                shapes=f"B={b}, D={d}, W={w}, tile {TILE}, "
                       f"{str(dtype).removeprefix('torch.')} rows")


def check_context_masks(dev) -> float:
    """Kernel 1 on non-banded random 0/1 masks (~30% ones, every 37th row
    empty, a span of F = 272 rows against one piece of 32): B = 4096,
    D = 200 in bf16 and float32 rows, and D = 37 in float32 (the scalar
    path: no 16-byte access fits that width); same edge rule and
    tolerances as the banded checks, and the by-id call bit-equal to the
    dense one (its pieces fetch their own row pointers)."""
    worst = 0.0
    for b, d, dtype in ((4096, D, torch.bfloat16), (4096, D, torch.float32),
                        (1024, 37, torch.float32)):
        tag = f"context@mask D={d} {str(dtype).removeprefix('torch.')}"
        args, rows = _context_inputs(dev, b, d, dtype, "random")
        print(f"[{tag}] {int(args[2].sum())} ones of {args[2].numel()}")
        worst = max(worst, _hold_context(args, b, tag))
        _hold_rows(args, rows, tag)
    return worst


# ------------------------------------------------------ the banded u-sum
def _band_usum_inputs(dev, b: int, d: int, seed: int):
    """The step's banded masks (W = 8, tile 256) on sentences of ~20 words
    with -1 padding at both ends, its shrinks, af from the valid centers,
    float32 cavge rows [b, d]."""
    from word2bits_tpu_torch.ops.windowed import build_banded_masks
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = b + 2 * W
    sents = torch.cumsum((torch.rand(n, generator=g) < 0.05).long(), 0)
    sents[:W] = sents[-W:] = -1
    shrink = torch.randint(0, W, (b,), generator=g)
    Mb, _, valid = build_banded_masks(sents.to(dev), shrink.to(dev), b, W,
                                      TILE)
    return Mb, valid.float(), torch.randn((b, d), generator=g).to(dev)


def check_band_usum(dev) -> dict:
    """The banded u-sum kernel (kernels/band_usum.py) against its plain
    version at the two CBOW cells' shapes (wiki B = 16384, D = 800; text8
    B = 8192, D = 200; W = 8, tile 256): within atol 1e-5 + rtol 1e-5 of
    the float64 sum and of the plain version, cnt equal to the plain
    version's, two launches bit-equal; then timed beside its bound, the
    plain version and torch.bmm of the dense mask alone (`library_ms`: the
    product the plain version's GEMM computes)."""
    import ctypes
    from word2bits_tpu_torch.kernels.band_usum import (
        _library, band_usum, band_usum_plain)
    from word2bits_tpu_torch.ops.windowed import banded_usum
    out = {}
    for tag, b, d in (("band usum@800", FLAG_B, FLAG_D),
                      ("band usum@200", B, D)):
        Mb, af, cav = _band_usum_inputs(dev, b, d, b + d)
        shape = (ctypes.c_int * 4)()
        if _library().w2b_band_usum_launch_shape(b, d, W, TILE,
                                                 ctypes.addressof(shape)):
            _fail(f"{tag}: the kernel refuses B = {b}, D = {d}")
        print(f"[{tag}] launch: {shape[1]} CTAs of {shape[2]} threads, "
              f"{shape[0]} slab rows a CTA, {shape[3]} bytes of dynamic "
              "shared memory")
        du, cnt = band_usum(Mb, af, cav, W, True)
        du2, cnt2 = band_usum(Mb, af, cav, W, True)
        torch.cuda.synchronize()
        if not (torch.equal(du, du2) and torch.equal(cnt, cnt2)):
            _fail(f"{tag}: two launches differ")
        plain_du, plain_cnt = band_usum_plain(Mb, af, cav, W, True)
        if not torch.equal(cnt, plain_cnt):
            _fail(f"{tag}: cnt differs from the plain version's")
        M_af = Mb * af.reshape(b // TILE, TILE)[:, :, None]
        du64, _ = banded_usum(M_af.double(), cav.double(), b, W)
        for name, want in (("float64", du64), ("plain", plain_du)):
            excess = ((du.double() - want.double()).abs()
                      - (1e-5 + 1e-5 * want.double().abs())).max()
            if excess > 0:
                _fail(f"{tag}: {excess:.3g} beyond atol 1e-5 + rtol 1e-5 "
                      f"of the {name} sum")
        err = _max_err(du, du64)
        ms = _time_ms(lambda: band_usum(Mb, af, cav, W, False))
        plain_ms = _time_ms(lambda: band_usum_plain(Mb, af, cav, W, False))
        cav3 = cav.reshape(b // TILE, TILE, d)
        library_ms = _time_ms(lambda: torch.bmm(M_af.transpose(1, 2), cav3))
        # bytes: cavge read once, du written once, the mask's band and af
        nbytes = b * d * 4 + (b + 2 * W) * d * 4 + b * (2 * W + 1) * 4 + b * 4
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[{tag}] max |err| {err:.3g} against the float64 sum; kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, torch.bmm of the "
              f"dense mask {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
              f"({nbytes} bytes)")
        out[d] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, library_ms=library_ms,
                      shapes=f"B={b}, D={d}, W={W}, tile {TILE}")
    return dict(name="band_usum", route="cuda",
                source="word2bits_tpu_torch/csrc/band_usum.cu",
                replaces="none: the dense torch.bmm of "
                         "ops/windowed.banded_usum (left to XLA by the JAX "
                         "package)",
                bound_by="bytes", at_d200=out[D], **out[FLAG_D])


# ------------------------------------- the subword gather-mean (row 11)
# the fasttext cell: 2,519,371 words + 2,000,000 buckets x 300, n-grams of
# 3-6 bytes, B 8192 centers drawn as a subsampled (1e-4) stream draws them
FT_V, FT_BUCKETS, FT_D, FT_B = 2_519_371, 2_000_000, 300, 8192
FT_FLAGS = ["-model", "fasttext", "-minn", "3", "-maxn", "6", "-bucket",
            str(FT_BUCKETS), "-size", str(FT_D), "-window", "5",
            "-negative", "5", "-sample", "1e-4", "-min-count", "5",
            "-alpha", "0.05", "-bitlevel", "1", "-batch-size", str(FT_B),
            "-steps-per-chunk", "32", "-iter", "1", "-binary", "1"]
FT_TOKENS, FT_TYPES = 4_000_000, 400_000      # [fasttext]'s reduced corpus


def _ft_words(n: int):
    """The fasttext cell's spelled words (benchmark/fasttext.py)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmark.fasttext import vocab_words
    return vocab_words(None, n)


def check_subword_mean(dev) -> dict:
    """The subword gather-mean (kernels/subword_mean.py) at the fasttext
    cell's shapes: the cell's 2,519,371 spelled words' subword rows
    (data/vocab.subword_rows on the card, timed), a [V + 2M, 300] float32
    table, 8,192 centers drawn from the cell's subsampled counts; bit-equal
    to its plain version at bitlevels 1 and 0, two launches bit-equal,
    within 1e-6 of the float64 mean; also on a bf16 table and at width 37
    (its scalar path); then timed beside its bound and its plain version."""
    from word2bits_tpu_torch.data.vocab import subword_rows
    from word2bits_tpu_torch.kernels.subword_mean import (subword_mean,
                                                          subword_mean_plain)
    from word2bits_tpu_torch.ops.quantize import quantize
    words = _ft_words(FT_V)
    t0 = time.perf_counter()
    sub = subword_rows(words, 3, 6, FT_BUCKETS, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lens = sub.offsets[1:] - sub.offsets[:-1]
    r = np.arange(1, FT_V, dtype=np.float64)
    c = np.maximum(5, np.floor(2_500_000 / r))
    st = 1e-4 * (c.sum() * 21 // 20)
    p = c * np.minimum((np.sqrt(c / st) + 1) * st / c, 1.0)
    p = np.concatenate([[0.0], p / p.sum()])
    mean_g = float((p * lens.cpu().numpy()).sum())
    print(f"[subword] {FT_V} words' subword rows built on the card in "
          f"{build_s:.2f} s: {sub.ids.numel()} rows, largest |G| "
          f"{sub.max_len}, mean |G| of a kept word {mean_g:.3f}")
    g = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.rand((sub.rows, FT_D), generator=g, device=dev) - 0.5
    centers = torch.multinomial(torch.from_numpy(p).to(dev), FT_B, True,
                                generator=g)
    for bl in (1, 0):
        h = subword_mean(table, centers, sub, bl)
        h2 = subword_mean(table, centers, sub, bl)
        plain = subword_mean_plain(table, centers, sub, bl)
        torch.cuda.synchronize()
        if not torch.equal(h, h2):
            _fail(f"[subword] bitlevel {bl}: two launches differ")
        if not torch.equal(h, plain):
            _fail(f"[subword] bitlevel {bl}: differs from the plain version "
                  f"by {_max_err(h, plain):.3g}")
    start = sub.offsets[centers]
    seg = torch.repeat_interleave(torch.arange(FT_B, device=dev),
                                  lens[centers])
    within = torch.arange(seg.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(lens[centers], 0) - lens[centers], lens[centers])
    rows = sub.ids[start[seg] + within].long()
    want = torch.zeros((FT_B, FT_D), dtype=torch.float64, device=dev)
    want.index_add_(0, seg, quantize(table[rows], 1).double())
    want /= lens[centers].double()[:, None]
    h = subword_mean(table, centers, sub, 1)
    err = _max_err(h, want)
    if err > 1e-6:
        _fail(f"[subword] {err:.3g} from the float64 mean")
    hb = subword_mean(table.bfloat16(), centers, sub, 1)
    if not torch.equal(hb, subword_mean_plain(table.bfloat16(), centers,
                                              sub, 1)):
        _fail("[subword] the bf16 table differs from the plain version")
    narrow = table[:, :37].contiguous()
    if not torch.equal(subword_mean(narrow, centers, sub, 2),
                       subword_mean_plain(narrow, centers, sub, 2)):
        _fail("[subword] width 37 differs from the plain version")
    ms = _time_ms(lambda: subword_mean(table, centers, sub, 1))
    plain_ms = _time_ms(lambda: subword_mean_plain(table, centers, sub, 1))
    n_rows = int(lens[centers].sum())
    nbytes = n_rows * (FT_D * 4 + 4) + FT_B * 3 * 8 + FT_B * FT_D * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[subword] B={FT_B}, D={FT_D}: {n_rows} rows gathered; max |err| "
          f"{err:.3g} against the float64 mean; kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({nbytes} bytes)")
    del table, narrow
    torch.cuda.empty_cache()
    return dict(name="subword_mean", route="cuda",
                source="word2bits_tpu_torch/csrc/subword_mean.cu",
                replaces="none: the subword model's gather-mean (the JAX "
                         "package has no subword model)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                shapes=f"B={FT_B}, D={FT_D}, {n_rows} rows, V={FT_V} + "
                       f"{FT_BUCKETS} buckets, CSR built in {build_s:.2f} s")


def run_fasttext(work: str, dev) -> dict:
    """[fasttext]: `cli train -model fasttext` at the cell's flags (2M
    buckets x 300, n-grams 3-6, NEG-5 a pair) for one epoch of a reduced
    corpus (4M tokens over 400,000 spelled words, Zipf), through the CLI's
    config parser and train.train; the vector file read back and 2,000 of
    its rows held to the plain mean of each word's quantized G_w rows;
    kernel 11 once a step and once an export block."""
    from word2bits_tpu_torch import train as train_mod
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.vocab import subword_rows
    from word2bits_tpu_torch.io.vectors import read_vectors
    from word2bits_tpu_torch.kernels.subword_mean import subword_mean_plain
    rng = np.random.default_rng(SEED)
    words = np.array(_ft_words(FT_TYPES + 1)[1:])
    p = 1.0 / np.arange(1, FT_TYPES + 1)
    toks = words[rng.choice(FT_TYPES, FT_TOKENS, p=p / p.sum())]
    corpus = os.path.join(work, "fasttext.txt")
    out = os.path.join(work, "fasttext.bin")
    with open(corpus, "w") as f:
        for i in range(0, FT_TOKENS, 20):
            f.write(" ".join(toks[i:i + 20]) + "\n")
    cfg = config_from_argv(["-train", corpus, "-output", out, "-debug", "1"]
                           + FT_FLAGS)
    _zero_launches()
    t0 = time.perf_counter()
    res = train_mod.train(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = _read_launches()
    V = res.vocab.size
    u, v = res.tables
    if u.shape != (V + FT_BUCKETS, FT_D) or v.shape != (V, FT_D):
        _fail(f"[fasttext] tables {tuple(u.shape)}, {tuple(v.shape)}")
    if not all(math.isfinite(x) for x in res.epoch_losses):
        _fail(f"[fasttext] epoch loss not finite: {res.epoch_losses}")
    blocks = -(-V // ((1 << 24) // FT_D))
    if launches["subword_mean"] != res.steps + blocks:
        _fail(f"[fasttext] kernel 11 launched {launches['subword_mean']} "
              f"times, {res.steps} steps + {blocks} export blocks expected")
    names, vecs = read_vectors(out)
    if names != res.vocab.words or vecs.shape != (V, FT_D):
        _fail("[fasttext] the vector file's words or shape")
    sub = subword_rows(res.vocab.words, 3, 6, FT_BUCKETS, dev)
    pick = torch.from_numpy(rng.choice(V, 2000, replace=False)).to(dev)
    want = subword_mean_plain(u, pick, sub, 1).cpu().numpy()
    err = float(np.abs(vecs[pick.cpu().numpy()] - want).max())
    if err > 0:
        _fail(f"[fasttext] exported vectors {err:.3g} from the mean of "
              "their quantized rows")
    us, wps = _steady(res)
    print(f"[fasttext] V={V} + {FT_BUCKETS} buckets x {FT_D}: {res.steps} "
          f"steps in {wall:.1f} s (the call), {us:.1f} us/step, "
          f"{wps:.0f} words/s on the card's clock; epoch loss "
          f"{res.epoch_losses[-1]:.2f}; vectors the mean of their rows; "
          f"launches {launches}")
    return launches


# ------------------------------- the position-weighted context (row 12)
# the ftcbow cell: 2,000,000 words + 2,000,000 buckets x 300, 5-grams,
# window 5, NEG-10 a center, B 8192
FTC_BUCKETS, FTC_D, FTC_W, FTC_B = 2_000_000, 300, 5, 8192
FTC_FLAGS = ["-model", "fasttext-cbow", "-minn", "5", "-maxn", "5",
             "-bucket", str(FTC_BUCKETS), "-size", str(FTC_D), "-window",
             str(FTC_W), "-negative", "10", "-sample", "1e-4",
             "-min-count", "5", "-alpha", "0.05", "-dtype", "float32",
             "-bitlevel", "1", "-batch-size", str(FTC_B),
             "-steps-per-chunk", "32", "-scatter-impl", "add", "-iter", "1",
             "-binary", "1"]
FTC_TOKENS, FTC_TYPES = 2_000_000, 200_000    # [ftcbow]'s reduced corpus
# dd's tolerance, of the sum of its terms' magnitudes: the kernel adds at
# most 8 + 8 + 129 partial sums in order, 8.6e-6 of that sum at float32's
# 2^-24 rounding (tests/test_torch_pos_context_card.py)
DD_RTOL = 1e-5


def check_pos_context(dev) -> dict:
    """The position-weighted context (kernels/pos_context.py) at the ftcbow
    cell's shapes: x [8202, 300], d [10, 300] and e [8192, 300] float32
    drawn on the card, the step's masks (cbow_slab._context_masks) of
    random sentences (padding at both ends and inside) and random shrinks;
    h and dx bit-equal to the plain versions, dd within DD_RTOL of its
    terms' magnitudes of the float64 sum, two launches bit-equal, one
    launch an entry; then each entry timed beside its bound and its plain
    version."""
    from word2bits_tpu_torch.kernels.pos_context import (
        pos_context, pos_context_grad, pos_context_grad_plain,
        pos_context_plain)
    from word2bits_tpu_torch.models import cbow_slab
    Bc, Dc, Wc = FTC_B, FTC_D, FTC_W
    n = Bc + 2 * Wc
    g = torch.Generator(device=dev).manual_seed(SEED)
    sents = torch.cumsum((torch.rand(n, generator=g, device=dev) < 0.05)
                         .long(), 0)
    sents[torch.rand(n, generator=g, device=dev) < 0.01] = -1
    sents[:Wc] = -1
    sents[-Wc:] = -1
    inputs = cbow_slab.SlabInputs(
        slab_tokens=torch.zeros(n, dtype=torch.long, device=dev),
        slab_sents=sents,
        shrink=torch.randint(0, Wc, (Bc,), generator=g, device=dev),
        neg_ids=None)
    m = cbow_slab._context_masks(inputs, Bc, Wc)[1].float().contiguous()
    x = torch.randn((n, Dc), generator=g, device=dev) * 0.3
    d = 1.0 + 0.2 * torch.randn((2 * Wc, Dc), generator=g, device=dev)
    e = torch.randn((Bc, Dc), generator=g, device=dev) * 0.02
    pos_context.launches = 0
    h = pos_context(x, d, m, Wc)
    dx, dd = pos_context_grad(e, x, d, m, Wc)
    torch.cuda.synchronize()
    if pos_context.launches != 2:
        _fail(f"[pos_context] {pos_context.launches} launches for one "
              "forward and one backward, 2 expected")
    if not torch.equal(h, pos_context(x, d, m, Wc)):
        _fail("[pos_context] two forward launches differ")
    dx2, dd2 = pos_context_grad(e, x, d, m, Wc)
    if not (torch.equal(dx, dx2) and torch.equal(dd, dd2)):
        _fail("[pos_context] two backward launches differ")
    plain = pos_context_plain(x, d, m, Wc)
    if not torch.equal(h, plain):
        _fail(f"[pos_context] h differs from the plain version by "
              f"{_max_err(h, plain):.3g}")
    pdx, pdd = pos_context_grad_plain(e, x, d, m, Wc)
    if not torch.equal(dx, pdx):
        _fail(f"[pos_context] dx differs from the plain version by "
              f"{_max_err(dx, pdx):.3g}")
    md, ed, xd = m.double(), e.double(), x.double()
    want = torch.empty(d.shape, dtype=torch.float64, device=dev)
    mag = torch.empty(d.shape, dtype=torch.float64, device=dev)
    offsets = [o for o in range(-Wc, Wc + 1) if o != 0]
    for p, o in enumerate(offsets):
        t = md[:, p, None] * ed * xd[Wc + o:Wc + o + Bc]
        want[p], mag[p] = t.sum(0), t.abs().sum(0)
    tol = DD_RTOL * mag + 1e-30
    for tag, got in (("kernel", dd), ("plain version", pdd)):
        if not ((got.double() - want).abs() <= tol).all():
            _fail(f"[pos_context] dd of the {tag} outside {DD_RTOL} of its "
                  "terms' magnitudes of the float64 sum")
    err = float((dd.double() - want).abs().max())
    fwd_ms = _time_ms(lambda: pos_context(x, d, m, Wc))
    bwd_ms = _time_ms(lambda: pos_context_grad(e, x, d, m, Wc))
    pfwd_ms = _time_ms(lambda: pos_context_plain(x, d, m, Wc))
    pbwd_ms = _time_ms(lambda: pos_context_grad_plain(e, x, d, m, Wc))
    # bytes, as benchmark/kernels/pos_context.py counts them: the forward
    # reads x, d and m and writes h; the backward reads e, x, d and m and
    # writes dx and dd; float32
    N, P = n, 2 * Wc
    nbytes = 4 * ((N * Dc + P * Dc + Bc * P + Bc * Dc)
                  + (Bc * Dc + N * Dc + P * Dc + Bc * P + N * Dc + P * Dc))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms, plain_ms = fwd_ms + bwd_ms, pfwd_ms + pbwd_ms
    print(f"[pos_context] B={Bc}, D={Dc}, W={Wc}, {int(m.sum())} live "
          f"(center, position) terms: h and dx bit-equal to the plain "
          f"versions, dd {err:.3g} from the float64 sum; forward "
          f"{fwd_ms:.5f} ms (plain {pfwd_ms:.5f}), backward {bwd_ms:.5f} ms "
          f"(plain {pbwd_ms:.5f}), both {ms:.5f} ms, bound {bound_ms:.5f} "
          f"ms ({nbytes} bytes)")
    del x, d, e, m, h, dx, dd, pdx, pdd, plain
    torch.cuda.empty_cache()
    return dict(name="pos_context", route="cuda",
                source="word2bits_tpu_torch/csrc/pos_context.cu",
                replaces="none: the position-weighted context of fastText "
                         "CBOW (the JAX package has no such model)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                forward_ms=fwd_ms, backward_ms=bwd_ms,
                plain_forward_ms=pfwd_ms, plain_backward_ms=pbwd_ms,
                shapes=f"B={Bc}, D={Dc}, W={Wc}: x [{N}, {Dc}], d [{P}, "
                       f"{Dc}], the step's masks")


def run_ftcbow(work: str, dev) -> dict:
    """[ftcbow]: `cli train -model fasttext-cbow` at the cell's flags (2M
    buckets x 300, 5-grams, window 5, NEG-10 a center) for one epoch of a
    reduced corpus (2M tokens over 200,000 spelled words, Zipf), through
    the CLI's config parser and train.train; kernel 12 twice a step and
    kernel 11 once a step and once an export block; d [10, 300] finite and
    moved from its ones; the vector file read back and 2,000 of its rows
    held to the plain mean of each word's quantized G_w rows."""
    from word2bits_tpu_torch import train as train_mod
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.vocab import subword_rows
    from word2bits_tpu_torch.io.vectors import read_vectors
    from word2bits_tpu_torch.kernels.subword_mean import subword_mean_plain
    rng = np.random.default_rng(SEED + 1)
    words = np.array(_ft_words(FTC_TYPES + 1)[1:])
    p = 1.0 / np.arange(1, FTC_TYPES + 1)
    toks = words[rng.choice(FTC_TYPES, FTC_TOKENS, p=p / p.sum())]
    corpus = os.path.join(work, "ftcbow.txt")
    out = os.path.join(work, "ftcbow.bin")
    with open(corpus, "w") as f:
        for i in range(0, FTC_TOKENS, 20):
            f.write(" ".join(toks[i:i + 20]) + "\n")
    cfg = config_from_argv(["-train", corpus, "-output", out, "-debug", "1"]
                           + FTC_FLAGS)
    _zero_launches()
    t0 = time.perf_counter()
    res = train_mod.train(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = _read_launches()
    V = res.vocab.size
    u, v, d = res.tables
    if (u.shape != (V + FTC_BUCKETS, FTC_D) or v.shape != (V, FTC_D)
            or d.shape != (2 * FTC_W, FTC_D)):
        _fail(f"[ftcbow] tables {tuple(u.shape)}, {tuple(v.shape)}, "
              f"{tuple(d.shape)}")
    if not (torch.isfinite(d).all() and (d != 1).any()):
        _fail("[ftcbow] the position weights are not finite or never moved")
    if not all(math.isfinite(x) for x in res.epoch_losses):
        _fail(f"[ftcbow] epoch loss not finite: {res.epoch_losses}")
    if launches["pos_context"] != 2 * res.steps:
        _fail(f"[ftcbow] kernel 12 launched {launches['pos_context']} "
              f"times, 2 a step of {res.steps} expected")
    blocks = -(-V // ((1 << 24) // FTC_D))
    if launches["subword_mean"] != res.steps + blocks:
        _fail(f"[ftcbow] kernel 11 launched {launches['subword_mean']} "
              f"times, {res.steps} steps + {blocks} export blocks expected")
    names, vecs = read_vectors(out)
    if names != res.vocab.words or vecs.shape != (V, FTC_D):
        _fail("[ftcbow] the vector file's words or shape")
    sub = subword_rows(res.vocab.words, 5, 5, FTC_BUCKETS, dev)
    pick = torch.from_numpy(rng.choice(V, 2000, replace=False)).to(dev)
    want = subword_mean_plain(u, pick, sub, 1).cpu().numpy()
    err = float(np.abs(vecs[pick.cpu().numpy()] - want).max())
    if err > 0:
        _fail(f"[ftcbow] exported vectors {err:.3g} from the mean of "
              "their quantized rows")
    us, wps = _steady(res)
    print(f"[ftcbow] V={V} + {FTC_BUCKETS} buckets x {FTC_D}, d "
          f"[{2 * FTC_W}, {FTC_D}]: {res.steps} steps in {wall:.1f} s (the "
          f"call), {us:.1f} us/step, {wps:.0f} words/s on the card's clock; "
          f"epoch loss {res.epoch_losses[-1]:.2f}; d in "
          f"[{float(d.min()):.4f}, {float(d.max()):.4f}]; vectors the mean "
          f"of their rows; launches {launches}")
    return launches


# ------------------------------------------------------- kernels 2 and 7
def _row_parts(dev, n_slab: int, n_neg: int, d: int, window: int):
    """The fused step's update rows as its three parts (RowParts), seeded
    float32 at the step's scale: u of the n_slab slab positions, v of the
    n_slab - 2 * window centers and of the n_neg negatives."""
    from word2bits_tpu_torch.kernels.span_scatter import RowParts
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    return RowParts(*(torch.randn((n, d), generator=gen, device=dev) * 0.01
                      for n in (n_slab, n_slab - 2 * window, n_neg)),
                    window)


def _parts_vs_dense(run, table: torch.Tensor, plan, parts, tag: str,
                    rows_of=None) -> dict:
    """`run(table, plan, rows)` (kernel 2 or 7) on the fused step's three
    parts and on the same rows materialized, each from `table`'s state
    (restored after each call; `rows_of` the rows it compares, all by
    default): bit-equal, both digests printed, then each call timed."""
    dense = parts.materialize()
    pick = (lambda t: t) if rows_of is None else (lambda t: t[rows_of])
    before = pick(table).clone()
    out = {}
    for name, rows in (("parts", parts), ("dense", dense)):
        run(table, plan, rows)
        out[name] = pick(table).clone()
        if rows_of is None:
            table.copy_(before)
        else:
            table[rows_of] = before
    torch.cuda.synchronize()
    if not torch.equal(_bits(out["parts"]), _bits(out["dense"])):
        _fail(f"{tag}: the three-part rows and the same rows materialized "
              f"give other tables, max abs err "
              f"{_max_err(out['parts'], out['dense']):.3e}")
    ms = {name: _time_ms(lambda: run(table, plan, rows))
          for name, rows in (("parts", parts), ("dense", dense))}
    print(f"[{tag}] three parts: digest {_digest(out['parts'])}, the "
          f"materialized rows' {_digest(out['dense'])}; kernel "
          f"{ms['parts']:.4f} ms from the parts, {ms['dense']:.4f} ms on "
          "the materialized rows")
    return dict(parts_ms=ms["parts"], parts_dense_ms=ms["dense"])


def check_span(dev) -> dict:
    """The span scatter kernel against scatter_add_span_plain on the card:
    a bf16 [70000, 400] table, Zipf ids with duplicates plus drop
    sentinels, float32 rows.  Both sum each id's bf16-rounded rows in
    float32 and round once into the table, in another order, so they agree
    to one bf16 rounding: atol 1e-5 + rtol 2^-7.  Two launches on the same
    inputs are bit-equal; the table's digest (_digest) is printed, to be
    held equal across commits.  Then the same scatter of the fused step's
    rows from their three parts, bit-equal to kernel 2 on them
    materialized (_parts_vs_dense)."""
    from word2bits_tpu_torch.kernels.span_scatter import (
        scatter_add_span_plain, scatter_add_span_planned, sort_plan)
    rng = np.random.default_rng(SEED)
    V, C, N = SCATTER_V, 2 * D, SCATTER_N
    ids = torch.from_numpy(_step_ids(rng, V, B + 2 * W, N - B - 2 * W,
                                     64)).to(dev)
    rows = (torch.randn((N, C), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 0.01)
    table0 = (torch.rand((V, C), generator=torch.Generator(
        device=dev).manual_seed(SEED + 1), device=dev) - 0.5).to(
        torch.bfloat16)
    plan = sort_plan(ids)
    got = scatter_add_span_planned(table0.clone(), plan, rows)
    again = scatter_add_span_planned(table0.clone(), plan, rows)
    want = scatter_add_span_plain(table0.clone(), ids, rows)
    torch.cuda.synchronize()
    err = _max_err(got, want)
    if not torch.allclose(got.float(), want.float(), atol=1e-5,
                          rtol=2 ** -7):
        _fail(f"span scatter: max abs err {err:.3e} > atol 1e-5 + "
              "rtol 2^-7")
    if not torch.equal(_bits(got), _bits(again)):
        _fail("span scatter: two launches on the same inputs differ")
    if torch.equal(got, table0):
        _fail("span scatter changed nothing")
    n_unique, longest = _sorted_runs(plan, V)
    print(f"[span] max abs err {err:.3e}; {N} rows, {n_unique} distinct "
          f"ids, longest run {longest}; the table's digest {_digest(got)}")
    scratch = table0.clone()
    ms = _time_ms(lambda: scatter_add_span_planned(scratch, plan, rows))
    plain_ms = _time_ms(lambda: scatter_add_span_plain(scratch, ids, rows))
    keep = ids < V
    ids_in, rows_in = ids[keep], rows[keep].to(torch.bfloat16)
    library_ms = _time_ms(lambda: scratch.index_add_(0, ids_in, rows_in))
    # bytes: rows and plan read once; each touched table row read and
    # written once
    nbytes = (rows.numel() * 4
              + sum(t.numel() * 4 for t in plan)
              + 2 * n_unique * C * 2)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[span] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    parts = _parts_vs_dense(scatter_add_span_planned, table0.clone(), plan,
                            _row_parts(dev, B + 2 * W, N - B - 2 * W, D, W),
                            "span")
    return dict(name="scatter_add_span", route="cuda",
                source="word2bits_tpu_torch/csrc/span_scatter.cu",
                replaces="word2bits_tpu/kernels/span_scatter.py:200",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                shapes=f"table [{V}, {C}] bf16, {N} f32 rows", **parts)


# the `add` routes' scatters through ops/scatter.scatter_add (sort + kernel
# 2): the Quick start's per-center v (B + B*K rows) and u (B + 2W rows)
# into float32 [V, D]; the hot head buffer, float32 [HOT, 2D] (the fused
# slab rows of a step, ids >= HOT dropped); a 2 x 2 mesh's v delta, float32
# [V/2, D] on vocab shard 0 (one data shard's B/2 centers and their
# negatives, the other shard's ids dropped); the per-pair skip-gram step
# at the published widths (benchmark cell sgns.pair-add): v (B + B*2W*K
# rows) and u (B + 2W rows) into float32 [692,001, 300]
QS_B = 256
SG_V, SG_D, SG_B, SG_W, SG_K = 692_001, 300, 8192, 5, 15


def check_span_paths(dev) -> dict:
    """Kernel 2 on the `add` routes' shapes through scatter_add: two calls
    bit-equal, and bit-equal to kernel 2 launched through sort_plan; each
    float32 table held against the float64 sum of its rows
    (atol 1e-5 + rtol 1e-5, as [spank edges] holds float32 tables; the
    plain version's own float32 sums are printed beside).  Then, on the
    card's clock, one `add`-route scatter through `index_add_` (the rows
    cast to the table dtype, as the routes called it) and through
    scatter_add (the stable sort and kernel 2), with the host's time to
    issue each (_host_us), at the Quick start's shapes, at the per-pair
    skip-gram step's (1,236,992 and 8,202 float32 rows into a
    [692,001, 300] float32 table) and at the shipped shape ([span]'s
    14,352 float32 rows into a [70,000, 400] bf16 table)."""
    from word2bits_tpu_torch.kernels.span_scatter import (
        SENTINEL, scatter_add_span_plain, scatter_add_span_planned, sort_plan)
    from word2bits_tpu_torch.ops.scatter import scatter_add
    rng = np.random.default_rng(SEED + 13)
    V, Vs = SCATTER_V, SCATTER_V // 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    qs_v = _step_ids(rng, V, QS_B, QS_B * K, 0)
    qs_u = _step_ids(rng, V, QS_B + 2 * W, 0, 0)
    hot_ids = _step_ids(rng, V, B + 2 * W, 0, 0)
    mesh_ids = _step_ids(rng, V, B // 2, (B // 2 // G) * P * K, 0)
    mesh_ids = np.where(mesh_ids < Vs, mesh_ids, SENTINEL)
    sg_v = _step_ids(rng, SG_V, SG_B, SG_B * 2 * SG_W * SG_K, 0)
    sg_u = _step_ids(rng, SG_V, SG_B + 2 * SG_W, 0, 0)
    cases = (("quickstart v", qs_v, V, D, torch.float32),
             ("quickstart u", qs_u, V, D, torch.float32),
             ("hot head", hot_ids, HOT, 2 * D, torch.float32),
             ("mesh delta", mesh_ids, Vs, D, torch.float32),
             ("sgns v", sg_v, SG_V, SG_D, torch.float32),
             ("sgns u", sg_u, SG_V, SG_D, torch.float32))
    out, times = {}, {}
    for name, ids_np, rows_t, C, tdt in cases:
        ids = torch.from_numpy(ids_np).to(dev)
        rows = torch.randn((ids.numel(), C), generator=gen, device=dev) * 0.01
        base = (torch.rand((rows_t, C), generator=gen, device=dev) - 0.5
                if name != "hot head" and name != "mesh delta"
                else torch.zeros((rows_t, C), device=dev))
        got = [scatter_add(base.clone().to(tdt), ids, rows) for _ in range(2)]
        planned = scatter_add_span_planned(base.clone().to(tdt),
                                           sort_plan(ids), rows)
        plain = scatter_add_span_plain(base.clone().to(tdt), ids, rows)
        keep = (ids >= 0) & (ids < rows_t)
        exact = base.double().index_add_(0, ids[keep],
                                         rows[keep].double()).float()
        torch.cuda.synchronize()
        if not torch.equal(_bits(got[0]), _bits(got[1])):
            _fail(f"span paths ({name}): two calls not bit-equal")
        if not torch.equal(_bits(got[0]), _bits(planned)):
            _fail(f"span paths ({name}): not bit-equal to kernel 2 through "
                  "sort_plan")
        err = _max_err(got[0], exact)
        if not torch.allclose(got[0], exact, atol=1e-5, rtol=1e-5):
            _fail(f"span paths ({name}): max abs err {err:.3e} against the "
                  "float64 sum > atol 1e-5 + rtol 1e-5")
        if torch.equal(got[0], base.to(tdt)):
            _fail(f"span paths ({name}): the table did not change")
        out[name] = dict(max_abs_err=err, plain_err=_max_err(plain, exact),
                         rows=int(ids.numel()), table=[rows_t, C],
                         digest=_digest(got[0]))
        print(f"[span paths] {name}: {ids.numel()} rows into "
              f"[{rows_t}, {C}] float32, two calls and the sort_plan "
              f"launch bit-equal (digest "
              f"{_digest(got[0])}), max abs err {err:.3e} against the float64 "
              f"sum (the plain version {out[name]['plain_err']:.3e})")
        del got, planned, plain, exact
    # one scatter through index_add_ and through sort + kernel 2
    span_ids = torch.from_numpy(_step_ids(np.random.default_rng(SEED), V,
                                          B + 2 * W, SCATTER_N - B - 2 * W,
                                          64)).to(dev)
    timed = (("quickstart v", torch.from_numpy(qs_v).to(dev), V, D,
              torch.float32),
             ("quickstart u", torch.from_numpy(qs_u).to(dev), V, D,
              torch.float32),
             ("sgns v", torch.from_numpy(sg_v).to(dev), SG_V, SG_D,
              torch.float32),
             ("sgns u", torch.from_numpy(sg_u).to(dev), SG_V, SG_D,
              torch.float32),
             ("shipped", span_ids, V, 2 * D, torch.bfloat16))
    for name, ids, rows_t, C, tdt in timed:
        rows = torch.randn((ids.numel(), C), generator=gen, device=dev) * 0.01
        scratch = (torch.rand((rows_t, C), generator=gen, device=dev)
                   - 0.5).to(tdt)
        keep = ids < rows_t
        ids_in, rows_in = ids[keep], rows[keep]
        def lib():
            return scratch.index_add_(0, ids_in, rows_in.to(tdt))

        def ours():
            return scatter_add(scratch, ids, rows)

        lib_ms, ms = _time_ms(lib), _time_ms(ours)
        lib_us, ours_us = _host_us(lib), _host_us(ours)
        sort_ms = _time_ms(lambda: torch.sort(ids.to(torch.int32),
                                              stable=True))
        n_touched = int(torch.unique(ids_in).numel())
        nbytes = (rows.numel() * 4 + ids.numel() * 8
                  + 2 * n_touched * C * scratch.element_size())
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        times[name] = dict(index_add_ms=lib_ms, sort_kernel2_ms=ms,
                           sort_ms=sort_ms, bound_ms=bound,
                           index_add_host_us=lib_us,
                           sort_kernel2_host_us=ours_us,
                           rows=int(ids.numel()))
        print(f"[span paths] one `add` scatter, {name} ({ids.numel()} rows "
              f"into [{rows_t}, {C}] {str(tdt)[6:]}): index_add_ "
              f"{lib_ms:.5f} ms, sort + kernel 2 {ms:.5f} ms "
              f"({ms / lib_ms:.2f}x; the sort alone {sort_ms:.5f}), bound "
              f"{bound:.5f} ms; host time to issue one call: index_add_ "
              f"{lib_us:.1f} us, sort + kernel 2 {ours_us:.1f} us "
              f"({_card_line()})")
    return dict(holds=out, times=times)


# ---------------------------------------------------------------- kernel 5
def _edge_pairs(f: torch.Tensor, eps: float = 2e-5) -> torch.Tensor:
    """Scores whose plain value lies within eps of a LUT bin edge ((f+6)*83
    an integer) or of +-6, where another float order may take the other
    side.  The dot products differ by ~1e-7 here; eps is 100 times that."""
    x = (f + 6.0) * 83.0
    lut = ((x - x.round()).abs() < 83.0 * eps) & (f.abs() <= 6.0)
    return lut | ((f.abs() - 6.0).abs() < eps)


def check_score(dev) -> dict:
    """quantized_scores_pallas against quantized_scores_plain on the card at
    the shipped shape: T = 128 tiles of G = 64 centers sharing P*K = 48
    negatives (2 pools), D = 200, float32, bitlevels 1 and 2, reg 0 and
    0.01.  Each output row sums 48 (cavge) or 64 (dv) LUT gradients, so a
    row holding a pair whose plain score sits at a LUT edge (_edge_pairs)
    is not compared; every other row: atol 1e-5 + rtol 1e-4.  Loss: rtol
    1e-5 plus the log-sigmoid jump for each pair at +-6."""
    from word2bits_tpu_torch.kernels.score_pallas import (
        _library, cluster_size, quantized_scores_pallas,
        quantized_scores_plain, smem_bytes)
    from word2bits_tpu_torch.ops.quantize import quantize
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    T, PK = SCORE_T, SCORE_PK
    lib = _library()
    for shape in ((G, PK, D), (9, 15, 37), (128, 24, 800)):
        for cl in (1, 2, 4):
            if (lib.w2b_score_smem_bytes(*shape, cl)
                    != smem_bytes(*shape, cl)):
                _fail(f"score kernel: the wrapper's shared-memory size at "
                      f"{shape}, cluster {cl} differs from the kernel's")
    cavg3 = torch.randn((T, G, D), generator=gen, device=dev) * 0.1
    v_rows = torch.rand((T, PK, D), generator=gen, device=dev) - 0.5
    centers3 = torch.randint(0, 70_000, (T, G), generator=gen, device=dev)
    negs = torch.randint(0, 70_000, (T, PK), generator=gen, device=dev)
    negs[:, :4] = centers3[:, :4]                # skipped negatives
    af3 = (torch.rand((T, G), generator=gen, device=dev) < 0.95).float()
    alpha = torch.full((1, 1), 0.05, device=dev)
    worst = 0.0
    for bl in (1, 2):
        for reg in (0.0, 0.01):
            args = (cavg3, v_rows, centers3, negs, af3, alpha, bl, reg, P)
            got = quantized_scores_pallas(*args)
            again = quantized_scores_pallas(*args)
            want = quantized_scores_plain(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                _fail(f"score kernel at bitlevel {bl}, reg {reg}: two "
                      "launches on the same inputs differ")
            f = torch.bmm(cavg3, quantize(v_rows, bl).transpose(1, 2))
            edge = _edge_pairs(f)
            keep_g = ~edge.any(dim=2)            # cavge rows [T, G]
            keep_k = ~edge.any(dim=1)            # dv rows [T, PK]
            errs = []
            for name, gt, wt, keep in (("cavge", got[0], want[0], keep_g),
                                       ("dv", got[1], want[1], keep_k)):
                gt, wt = gt[keep], wt[keep]
                if not torch.allclose(gt, wt, atol=1e-5, rtol=1e-4):
                    _fail(f"score kernel {name} at bitlevel {bl}, reg {reg}:"
                          f" max abs err {_max_err(gt, wt):.3e} > atol 1e-5"
                          " + rtol 1e-4")
                errs.append(_max_err(gt, wt))
            worst = max(worst, *errs)
            n6 = int((((f.abs() - 6.0).abs() < 2e-5)
                      & (af3[:, :, None] > 0)).sum())
            lg, lw = float(got[2]), float(want[2])
            allow = 1e-5 * abs(lw) + max(_JUMP_LO, _JUMP_HI) * n6
            if not math.isfinite(lg) or abs(lg - lw) > allow:
                _fail(f"score kernel loss at bitlevel {bl}, reg {reg}: {lg} "
                      f"vs {lw} (allowed {allow:.4g})")
            print(f"[score] bitlevel {bl}, reg {reg}: max abs err "
                  f"{max(errs):.3e} over {int(keep_g.sum())} of {T * G} "
                  f"cavge rows and {int(keep_k.sum())} of {T * PK} dv rows "
                  f"({int(edge.sum())} pairs at a score edge); loss "
                  f"{lg:.6f} vs plain {lw:.6f}; two launches bit-equal")
    args = (cavg3, v_rows, centers3, negs, af3, alpha, 1, 0.0, P)
    ms = _time_ms(lambda: quantized_scores_pallas(*args))
    plain_ms = _time_ms(lambda: quantized_scores_plain(*args))
    q = quantize(v_rows, 1)
    gm = torch.randn((T, G, PK), generator=gen, device=dev)

    def products():
        torch.bmm(cavg3, q.transpose(1, 2))
        torch.bmm(gm, q)
        torch.bmm(gm.transpose(1, 2), cavg3)
    bmm_ms = _time_ms(products)
    # bytes: each input read once, each output written once; operations:
    # the three [G x D x PK] products per tile, float32 multiply-adds
    nbytes = sum(t.numel() * t.element_size()
                 for t in (cavg3, v_rows, centers3, negs, af3, alpha))
    nbytes += (T * G * D + T * PK * D + T) * 4
    flops = 3 * 2 * T * G * PK * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    cl = cluster_size(G, PK, D)
    print(f"[score] clusters of {cl} CTAs a tile ({T * cl} CTAs of "
          f"{lib.w2b_score_threads()} threads, {smem_bytes(G, PK, D, cl)} "
          f"bytes of shared memory each)")
    print(f"[score] bitlevel 1 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"the three bmm products alone {bmm_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms for {nbytes} bytes, "
          f"float32 operations {ops_ms:.4f} ms for {flops} flop)")
    return dict(name="quantized_scores_pallas", route="cuda",
                source="word2bits_tpu_torch/csrc/score.cu",
                replaces="word2bits_tpu/kernels/score_pallas.py:110",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, bmm_only_ms=bmm_ms, config=dict(
                    cluster=cl, threads=lib.w2b_score_threads()),
                shapes=f"T={T}, G={G}, P*K={PK}, D={D}, f32")


# (T, G, P, K, D): T = 1, T not a multiple of the cluster size, P = 1, 2
# and 3, ragged G, P*K and D (D = 37 and 203: 4-byte copies), and the
# capacity width D = 800 (too wide for one CTA: a cluster of 2 at least)
SCORE_EDGE_CASES = ((1, 64, 2, 24, 200), (3, 9, 3, 5, 37), (5, 13, 1, 7, 8),
                    (2, 64, 3, 16, 203), (7, 128, 1, 24, 100),
                    (3, 64, 1, 24, 800))


def check_score_edges(dev) -> None:
    """Kernel 5 at the cluster design's edges (SCORE_EDGE_CASES) at
    bitlevels 0, 1, 2, 4 and 8, reg 0 and 0.01, with clusters of 1, 2 and
    4 CTAs a tile (the wrapper's CLUSTER set for the check): against the
    plain version with [score]'s tolerance (rows holding a pair at a score
    edge are not compared), the loss too, and two launches bit-equal."""
    from word2bits_tpu_torch.kernels import score_pallas
    from word2bits_tpu_torch.kernels.score_pallas import (
        quantized_scores_pallas, quantized_scores_plain)
    from word2bits_tpu_torch.ops.quantize import quantize
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    worst, n = 0.0, 0
    kept = score_pallas.CLUSTER
    for (T, G_, P_, K_, D_), cl in ((c, cl) for c in SCORE_EDGE_CASES
                                    for cl in (1, 2, 4)):
        score_pallas.CLUSTER = cl
        PK = P_ * K_
        cavg3 = torch.randn((T, G_, D_), generator=gen, device=dev) * 0.1
        v_rows = torch.rand((T, PK, D_), generator=gen, device=dev) - 0.5
        centers3 = torch.randint(0, 50, (T, G_), generator=gen, device=dev)
        negs = torch.randint(0, 50, (T, PK), generator=gen, device=dev)
        negs[:, 0] = centers3[:, 0]
        af3 = (torch.rand((T, G_), generator=gen, device=dev) < 0.9).float()
        alpha = torch.full((1, 1), 0.05, device=dev)
        for bl in (0, 1, 2, 4, 8):
            for reg in (0.0, 0.01):
                args = (cavg3, v_rows, centers3, negs, af3, alpha, bl, reg,
                        P_)
                got = quantized_scores_pallas(*args)
                again = quantized_scores_pallas(*args)
                want = quantized_scores_plain(*args)
                torch.cuda.synchronize()
                tag = (f"T={T}, G={G_}, P={P_}, K={K_}, D={D_}, cluster "
                       f"{cl}, bitlevel {bl}, reg {reg}")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    _fail(f"score edges ({tag}): two launches differ")
                f = torch.bmm(cavg3, quantize(v_rows, bl).transpose(1, 2))
                edge = _edge_pairs(f)
                for name, gt, wt, keep in (
                        ("cavge", got[0], want[0], ~edge.any(dim=2)),
                        ("dv", got[1], want[1], ~edge.any(dim=1))):
                    gt, wt = gt[keep], wt[keep]
                    if gt.numel() and not torch.allclose(gt, wt, atol=1e-5,
                                                         rtol=1e-4):
                        _fail(f"score edges ({tag}) {name}: max abs err "
                              f"{_max_err(gt, wt):.3e} > atol 1e-5 + rtol "
                              "1e-4")
                    if gt.numel():
                        worst = max(worst, _max_err(gt, wt))
                n6 = int((((f.abs() - 6.0).abs() < 2e-5)
                          & (af3[:, :, None] > 0)).sum())
                lg, lw = float(got[2]), float(want[2])
                allow = 1e-5 * abs(lw) + max(_JUMP_LO, _JUMP_HI) * n6
                if not math.isfinite(lg) or abs(lg - lw) > allow:
                    _fail(f"score edges ({tag}) loss: {lg} vs {lw} (allowed "
                          f"{allow:.4g})")
                n += 1
    score_pallas.CLUSTER = kept
    print(f"[score edges] {n} cases ((T, G, P, K, D) in {SCORE_EDGE_CASES}, "
          f"bitlevels 0/1/2/4/8, reg 0 and 0.01, clusters of 1, 2 and 4 "
          f"CTAs, 2 at least at D = 800): two launches bit-equal, max abs "
          f"err {worst:.3e}")


# ---------------------------------------------------------------- kernel 3
def check_rank1(dev) -> dict:
    """scatter_add_span_rank1 against its plain version at the exact-mode
    shape: a float32 [69,998, 200] table, 4,096 dense center rows and
    4,096 * 24 rank-1 rows g[j] * cavg[j // 24], the ids drawn like one
    step (subsampled Zipf(1.05) centers, unigram^0.75 negatives).  Both sum
    each id's rows in float32 in another order: atol 1e-5 + rtol 1e-5.
    Kernel 2 on the same rows materialized (the exact mode's float32 v
    scatter) is bit-equal to kernel 3, held to the same tolerance against
    its plain version and the rank-1 plain version, and timed beside it,
    with and without forming the rows; so is index_add_ of the
    materialized rows."""
    from word2bits_tpu_torch.kernels.span_scatter import (
        scatter_add_span_plain, scatter_add_span_planned,
        scatter_add_span_rank1, scatter_add_span_rank1_plain, sort_plan)
    rng = np.random.default_rng(SEED + 3)
    V, nd = RANK1_V, RANK1_ND
    nn = nd * K
    ids = torch.from_numpy(_step_ids(rng, V, nd, nn, 0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    dense = torch.randn((nd, D), generator=gen, device=dev) * 0.01
    g = torch.randn((nn,), generator=gen, device=dev) * 0.01
    cavg = torch.randn((nd, D), generator=gen, device=dev) * 0.1
    table0 = torch.rand((V, D), generator=gen, device=dev) - 0.5
    plan = sort_plan(ids)
    got = scatter_add_span_rank1(table0.clone(), plan, dense, g, cavg, K)
    want = scatter_add_span_rank1_plain(table0.clone(), plan, dense, g,
                                        cavg, K)
    torch.cuda.synchronize()
    err = _max_err(got, want)
    if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
        _fail(f"rank-1 span scatter: max abs err {err:.3e} > atol 1e-5 + "
              "rtol 1e-5")
    if torch.equal(got, table0):
        _fail("rank-1 span scatter changed nothing")
    src = torch.arange(nn, device=dev) // K

    def materialize():
        return torch.cat([dense, g[:, None] * cavg[src]])
    rows = materialize()
    mat = scatter_add_span_planned(table0.clone(), plan, rows)
    mat_plain = scatter_add_span_plain(table0.clone(), ids, rows)
    torch.cuda.synchronize()
    # kernel 2 at the exact mode's float32 v scatter: against its own
    # plain version and against the rank-1 plain version, same tolerance
    mat_err = max(_max_err(mat, mat_plain), _max_err(mat, want))
    if not (torch.allclose(mat, mat_plain, atol=1e-5, rtol=1e-5)
            and torch.allclose(mat, want, atol=1e-5, rtol=1e-5)):
        _fail(f"span scatter on the materialized rows (float32 table): max "
              f"abs err {mat_err:.3e} > atol 1e-5 + rtol 1e-5")
    if not torch.equal(got, mat):
        _fail(f"rank-1 span scatter vs kernel 2 on its rows materialized: "
              f"max abs err {_max_err(got, mat):.3e}, not bit-equal")
    n_unique, _ = _sorted_runs(plan, V)
    print(f"[rank1] max abs err {err:.3e} against the plain version; "
          f"kernel 2 on the materialized rows {mat_err:.3e} against the "
          f"plain versions, bit-equal to kernel 3; "
          f"{nd} + {nn} rows, {n_unique} distinct ids")
    scratch = table0.clone()
    ms = _time_ms(lambda: scatter_add_span_rank1(scratch, plan, dense, g,
                                                 cavg, K))
    plain_ms = _time_ms(lambda: scatter_add_span_rank1_plain(
        scratch, plan, dense, g, cavg, K))
    span_ms = _time_ms(lambda: scatter_add_span_planned(scratch, plan, rows))
    span_plain_ms = _time_ms(lambda: scatter_add_span_plain(scratch, ids,
                                                            rows))
    span_form_ms = _time_ms(lambda: scatter_add_span_planned(
        scratch, plan, materialize()))
    library_ms = _time_ms(lambda: scratch.index_add_(0, ids, rows))
    # bytes: dense rows, g, cavg and the plan read once; each touched
    # table row read and written once
    nbytes = ((dense.numel() + g.numel() + cavg.numel()) * 4
              + sum(t.numel() * 4 for t in plan) + 2 * n_unique * D * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # kernel 2's bound there: the materialized rows in place of the dense
    # rows, g and cavg
    span_bytes = (rows.numel() * 4 + sum(t.numel() * 4 for t in plan)
                  + 2 * n_unique * D * 4)
    span_bound_ms = span_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[rank1] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; kernel 2 on "
          f"the materialized rows {span_ms:.4f} ms ({span_form_ms:.4f} ms "
          f"with forming them; its plain version {span_plain_ms:.4f} ms, "
          f"its bound {span_bound_ms:.4f} ms), index_add_ of them "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({nbytes} bytes)")
    return dict(name="scatter_add_span_rank1", route="cuda",
                source="word2bits_tpu_torch/csrc/span_scatter.cu",
                replaces="word2bits_tpu/kernels/span_scatter.py:268",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                span_materialized_ms=span_ms,
                span_materialized_with_forming_ms=span_form_ms,
                span_at_exact=dict(
                    max_abs_err=mat_err, ms=span_ms, plain_ms=span_plain_ms,
                    bound_ms=span_bound_ms, library_ms=library_ms,
                    shapes=f"table [{V}, {D}] f32, {nd + nn} f32 rows"),
                shapes=f"table [{V}, {D}] f32, {nd} dense + {nn} rank-1 "
                       f"rows")


def _span_edge_ids(rng, L: int) -> np.ndarray:
    """6,400 ids whose sorted stream (tiles of L slots) starts with runs of
    L (a whole tile, uncut), L - 1 and 1, L + 1 (cut once), 2L + 1 (over
    three tiles, the middle one whole), 3, L - 1 (cut), L, 2L + 1 and L + 1
    rows, then Zipf ids and 64 drop sentinels, shuffled."""
    from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
    lens = [L, L - 1, 1, L + 1, 2 * L + 1, 3, L - 1, L, 2 * L + 1, L + 1]
    head = np.repeat(np.arange(len(lens)), lens)
    n_rest = 6400 - head.size - 64
    rest = len(lens) + np.minimum(rng.zipf(1.3, n_rest) - 1, 3000)
    ids = np.concatenate([head, rest, np.full(64, SENTINEL)])
    rng.shuffle(ids)
    return ids.astype(np.int64)


def check_span_edges(dev, widths=(200, 400, 37, 1600)) -> None:
    """Kernels 2 and 3 at the tiled design's edges, for each dtype pair (a
    bf16 table with float32 and with bf16 rows, a float32 table) at widths
    200, 400, 37 (one column a thread) and 1,600: one id holding all
    102,400 rows, the runs of _span_edge_ids (L - 1, L, L + 1 and 2L + 1
    rows at several offsets from the tile edges), a plan of drop sentinels
    only, and N = 0.  The rows are rank-1 rows as in [rank1] (4% dense,
    96% g[j] * cavg[j // 24]).  Kernel 3 is bit-equal to kernel 2 on its
    rows materialized, and two launches of each are bit-equal.  A bf16
    table is held against scatter_add_span_plain (atol 1e-5 + rtol 2^-7); a
    float32 table against the float64 sum of its rows rounded to float32
    (atol 1e-5 + rtol 1e-5), since the plain version's own float32 sums
    (index_add_'s running sum over one id's 102,400 rows) are further from
    it than that; its distance is printed."""
    from word2bits_tpu_torch.kernels.span_scatter import (
        SENTINEL, _library, scatter_add_span_plain, scatter_add_span_planned,
        scatter_add_span_rank1, sort_plan)
    TILE = _library().w2b_span_tile()
    rng = np.random.default_rng(SEED + 7)
    V, per_src = 4096, K
    plans = {
        "one id": np.full(RANK1_ND * (1 + per_src), 7),
        "runs": _span_edge_ids(rng, TILE),
        "sentinels only": np.full(25 * 40, SENTINEL),
        "N = 0": np.zeros(0, dtype=np.int64)}
    worst = {"bf16": 0.0, "f32": 0.0}
    plain_f32 = 0.0
    for what, ids_np in plans.items():
        ids = torch.from_numpy(ids_np).to(dev)
        plan = sort_plan(ids)
        nd = ids.numel() // (1 + per_src)
        nn = ids.numel() - nd
        for C in widths:
            gen = torch.Generator(device=dev).manual_seed(SEED + C)
            dense = torch.randn((nd, C), generator=gen, device=dev) * 0.01
            g = torch.randn((nn,), generator=gen, device=dev) * 0.01
            cavg = torch.randn((nd, C), generator=gen, device=dev) * 0.1
            rows = torch.cat([dense, g[:, None] * cavg[
                torch.arange(nn, device=dev) // per_src]])
            base = torch.rand((V, C), generator=gen, device=dev) - 0.5
            for tdt, rdt in ((torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.float32)):
                table0 = base.to(tdt)
                k2 = [scatter_add_span_planned(table0.clone(), plan,
                                               rows.to(rdt))
                      for _ in range(2)]
                k3 = [scatter_add_span_rank1(table0.clone(), plan,
                                             dense.to(rdt), g, cavg, per_src)
                      for _ in range(2)]
                # kernel 2 on kernel 3's rows materialized: float32 rows,
                # the dense ones already in rdt
                mat = scatter_add_span_planned(table0.clone(), plan, torch.cat(
                    [dense.to(rdt).float(), rows[nd:]]))
                plain = scatter_add_span_plain(table0.clone(), ids,
                                               rows.to(rdt))
                torch.cuda.synchronize()
                tag = (f"{what}, {str(tdt)[6:]} table, {str(rdt)[6:]} rows, "
                       f"width {C}")
                for x, y, name in ((k2[0], k2[1], "kernel 2 twice"),
                                   (k3[0], k3[1], "kernel 3 twice"),
                                   (k3[0], mat, "kernel 3 vs kernel 2 on "
                                    "its rows")):
                    if not torch.equal(_bits(x), _bits(y)):
                        _fail(f"span edges ({tag}): {name} not bit-equal, "
                              f"max abs err {_max_err(x, y):.3e}")
                if nd == 0 or what == "sentinels only":
                    if not torch.equal(_bits(k2[0]), _bits(table0)):
                        _fail(f"span edges ({tag}): the table changed")
                if tdt == torch.bfloat16:
                    err = _max_err(k2[0], plain)
                    if not torch.allclose(k2[0].float(), plain.float(),
                                          atol=1e-5, rtol=2 ** -7):
                        _fail(f"span edges ({tag}): max abs err {err:.3e} "
                              "against the plain version > atol 1e-5 + rtol "
                              "2^-7")
                    worst["bf16"] = max(worst["bf16"], err)
                    continue
                keep = ids < V
                exact = base.double().index_add_(
                    0, ids[keep], rows[keep].double()).float()
                err = _max_err(k2[0], exact)
                if not torch.allclose(k2[0], exact, atol=1e-5, rtol=1e-5):
                    _fail(f"span edges ({tag}): max abs err {err:.3e} "
                          "against the float64 sum > atol 1e-5 + rtol 1e-5")
                worst["f32"] = max(worst["f32"], err)
                plain_f32 = max(plain_f32, _max_err(plain, exact))
    print(f"[spank edges] tiles of {TILE} slots; {', '.join(plans)} at "
          f"widths {', '.join(map(str, widths))} in 3 dtype pairs: two "
          f"launches bit-equal, kernel 3 bit-equal to kernel 2 on its rows; "
          f"max abs err {worst['bf16']:.3e} against the plain version (bf16 "
          f"tables), {worst['f32']:.3e} against the float64 sum (float32 "
          f"tables; the plain version {plain_f32:.3e})")


# ---------------------------------------------------------------- kernel 7
def check_grmw(dev, n_slab: int = FLAG_B + 2 * W,
               n_neg: int = FLAG_N - FLAG_B - 2 * W,
               tag: str = "grmw") -> dict:
    """The group-RMW kernel against its plain version at the flagship:
    two copies of one random bf16 [3,699,941, 1,600] table, one step's
    float32 rows, n_slab slab rows and n_neg negative rows (22,544 rows in
    all at [flagship]'s window 8 and 24 negatives, the default; 18,954 at
    [flagship run]'s window 5 and 10 negatives: subsampled Zipf(1.05)
    slab ids, unigram^0.75 negatives, 64 drop sentinels).  Touched rows: atol 1e-5 + rtol 2^-7
    (each id's bf16-rounded rows summed in float32 in another order, one
    rounding into the table); every other row must be untouched in both.
    The digest of the touched rows (in id order) is printed, to be held
    equal across commits.  Then the same scatter of the fused step's rows
    from their three parts (B = 16,384 centers, the window from n_slab),
    bit-equal to kernel 7 on them materialized (_parts_vs_dense)."""
    from word2bits_tpu_torch.kernels.group_rmw import (
        scatter_add_grmw_plain, scatter_add_grmw_planned, tile_config)
    from word2bits_tpu_torch.kernels.span_scatter import sort_plan
    rng = np.random.default_rng(SEED + 7)
    V, C, N = FLAG_V, 2 * FLAG_D, n_slab + n_neg
    ids = torch.from_numpy(_step_ids(rng, V, n_slab, n_neg, 64)).to(dev)
    rows = (torch.randn((N, C), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 0.01)
    got = torch.empty((V, C), dtype=torch.bfloat16, device=dev)
    got.uniform_(-0.5, 0.5, generator=torch.Generator(
        device=dev).manual_seed(SEED + 1))
    want = got.clone()
    plan = sort_plan(ids)
    touched = torch.unique(ids[ids < V])
    before = got[touched]
    scatter_add_grmw_planned(got, plan, rows)
    first = got[touched]
    got[touched] = before                       # and once more
    scatter_add_grmw_planned(got, plan, rows)
    scatter_add_grmw_plain(want, ids, rows)
    torch.cuda.synchronize()
    if not torch.equal(_bits(first), _bits(got[touched])):
        _fail(f"{tag}: two launches on the same inputs differ")
    del before, first
    g, w = got[touched].float(), want[touched].float()
    err = _max_err(g, w)
    if not torch.allclose(g, w, atol=1e-5, rtol=2 ** -7):
        _fail(f"{tag}: max abs err {err:.3e} on the touched rows > atol "
              "1e-5 + rtol 2^-7")
    untouched = torch.ones(V, dtype=torch.bool, device=dev)
    untouched[touched] = False
    step = 1 << 18
    for r0 in range(0, V, step):
        m = untouched[r0:r0 + step]
        if not torch.equal(got[r0:r0 + step][m], want[r0:r0 + step][m]):
            _fail(f"{tag} wrote rows it was not given (rows {r0}..)")
    n_groups = int(torch.unique(touched >> 4).numel())
    cfg = tile_config()
    print(f"[{tag}] max abs err {err:.3e}; {N} rows, {touched.numel()} "
          f"distinct ids in {n_groups} groups; two launches bit-equal; the "
          f"touched rows' digest {_digest(got[touched])} (the rest held "
          f"untouched); tiles of {cfg['L']} slots, {cfg['THREADS']} threads, "
          f"chunks of {cfg['SUB']} rows, {cfg['IB']} in flight, groups of at "
          f"most {cfg['GROUP']} columns")
    parts = _parts_vs_dense(
        scatter_add_grmw_planned, got, plan,
        _row_parts(dev, n_slab, n_neg, FLAG_D, (n_slab - FLAG_B) // 2), tag,
        rows_of=touched)
    ms = _time_ms(lambda: scatter_add_grmw_planned(got, plan, rows))
    plain_ms = _time_ms(lambda: scatter_add_grmw_plain(want, ids, rows))
    keep = ids < V
    ids_in, rows_in = ids[keep], rows[keep].to(torch.bfloat16)
    library_ms = _time_ms(lambda: got.index_add_(0, ids_in, rows_in))
    # bytes: rows and plan read once; each touched row read and written
    nbytes = (rows.numel() * 4 + sum(t.numel() * 4 for t in plan)
              + 2 * touched.numel() * C * 2)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    del got, want
    torch.cuda.empty_cache()
    return dict(name="scatter_add_grmw", route="cuda",
                source="word2bits_tpu_torch/csrc/group_rmw.cu",
                replaces="word2bits_tpu/kernels/group_rmw.py:184",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                config=cfg, shapes=f"table [{V}, {C}] bf16, {N} f32 rows",
                **parts)


def _grmw_edge_plans(rng, L: int) -> dict:
    """Id sets at the edges of kernel 7's tiles (L slots): one id holding
    80% of 12,800 rows beside Zipf ids, drop sentinels and negative ids
    (its run longer than many tiles); one id holding all of them; N below
    one tile; sentinels and negative ids only; N = 0."""
    from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
    n = 12_800
    head = np.minimum(rng.zipf(1.3, n) - 1, 3000) + 10
    head[rng.random(n) < 0.8] = 5
    head[rng.choice(n, 64, replace=False)] = SENTINEL
    head[rng.choice(n, 16, replace=False)] = -1
    head[rng.choice(n, 4, replace=False)] = -7
    short = np.minimum(rng.zipf(1.3, L - 7) - 1, 40)
    short[:3] = SENTINEL
    dropped = np.where(rng.random(1000) < 0.5, SENTINEL, -3)
    return {"head 80%": head.astype(np.int64),
            "one id": np.full(n, 9, dtype=np.int64),
            f"N = {L - 7}": short.astype(np.int64),
            "sentinels and negative ids only": dropped.astype(np.int64),
            "N = 0": np.zeros(0, dtype=np.int64)}


def check_grmw_edges(dev, widths=(37, 200, 1600)) -> dict:
    """Kernel 7 at its tiles' edges (_grmw_edge_plans), for each dtype pair
    (a bf16 table with float32 and with bf16 rows, a float32 table with
    float32 rows) at widths 37 (one column a thread), 200 and 1,600: two
    launches bit-equal; ids outside [0, V) dropped (a plan of them only
    leaves the table as it was); a bf16 table held against its plain
    version (atol 1e-5 + rtol 2^-7), a float32 one against the float64 sum
    of its rows (atol 1e-5 + rtol 1e-5).  Kernel 7 and kernel 2 are timed
    on the "head 80%" rows at each width (bf16 table, float32 rows)."""
    from word2bits_tpu_torch.kernels.group_rmw import (
        scatter_add_grmw_plain, scatter_add_grmw_planned, tile_config)
    from word2bits_tpu_torch.kernels.span_scatter import (
        scatter_add_span_planned, sort_plan)
    L = tile_config()["L"]
    rng = np.random.default_rng(SEED + 8)
    V = 4096
    worst = {"bf16": 0.0, "f32": 0.0}
    times = {}
    for what, ids_np in _grmw_edge_plans(rng, L).items():
        ids = torch.from_numpy(ids_np).to(dev)
        plan = sort_plan(ids)       # kernels 7 and 2 read the same sort
        for C in widths:
            gen = torch.Generator(device=dev).manual_seed(SEED + C)
            rows = torch.randn((ids.numel(), C), generator=gen,
                               device=dev) * 0.01
            base = torch.rand((V, C), generator=gen, device=dev) - 0.5
            for tdt, rdt in ((torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.float32)):
                table0 = base.to(tdt)
                r = rows.to(rdt)
                k7 = [scatter_add_grmw_planned(table0.clone(), plan, r)
                      for _ in range(2)]
                plain = scatter_add_grmw_plain(table0.clone(), ids, r)
                torch.cuda.synchronize()
                tag = (f"{what}, {str(tdt)[6:]} table, {str(rdt)[6:]} rows, "
                       f"width {C}")
                if not torch.equal(_bits(k7[0]), _bits(k7[1])):
                    _fail(f"grmw edges ({tag}): two launches not bit-equal, "
                          f"max abs err {_max_err(k7[0], k7[1]):.3e}")
                keep = (ids >= 0) & (ids < V)
                if not bool(keep.any()) and not torch.equal(
                        _bits(k7[0]), _bits(table0)):
                    _fail(f"grmw edges ({tag}): the table changed")
                if tdt == torch.bfloat16:
                    err = _max_err(k7[0], plain)
                    if not torch.allclose(k7[0].float(), plain.float(),
                                          atol=1e-5, rtol=2 ** -7):
                        _fail(f"grmw edges ({tag}): max abs err {err:.3e} "
                              "against the plain version > atol 1e-5 + rtol "
                              "2^-7")
                    worst["bf16"] = max(worst["bf16"], err)
                else:
                    exact = base.double().index_add_(
                        0, ids[keep], rows[keep].double()).float()
                    err = _max_err(k7[0], exact)
                    if not torch.allclose(k7[0], exact, atol=1e-5,
                                          rtol=1e-5):
                        _fail(f"grmw edges ({tag}): max abs err {err:.3e} "
                              "against the float64 sum > atol 1e-5 + rtol "
                              "1e-5")
                    worst["f32"] = max(worst["f32"], err)
                if what == "head 80%" and tdt == torch.bfloat16 \
                        and rdt == torch.float32:
                    scratch = table0.clone()
                    times[C] = (
                        _time_ms(lambda: scatter_add_grmw_planned(
                            scratch, plan, r)),
                        _time_ms(lambda: scatter_add_span_planned(
                            scratch, plan, r)))
    print(f"[grmw edges] tiles of {L} slots; "
          f"{', '.join(_grmw_edge_plans(np.random.default_rng(0), L))} at "
          f"widths {', '.join(map(str, widths))} in 3 dtype pairs: two "
          f"launches bit-equal; max abs err {worst['bf16']:.3e} against the "
          f"plain version (bf16 tables), {worst['f32']:.3e} against the "
          f"float64 sum (float32 tables)")
    print("[grmw edges] 12,800 rows, one id holding 80%, into a [4096, C] "
          "bf16 table: " + "; ".join(
              f"width {C}: kernel 7 {a:.5f} ms, kernel 2 {b:.5f} ms"
              for C, (a, b) in times.items()))
    return {str(C): dict(ms=a, span_ms=b) for C, (a, b) in times.items()}


# ---------------------------------------------------------------- kernel 6
def _hot_bytes(ids: torch.Tensor, H: int, C: int, extra: bool) -> int:
    """The bytes kernel 6's function must move: the ids (int64) and the hot
    rows (float32) read once; with `extra`, extra read and every head row
    read and written once (bf16), without it only the touched head rows."""
    hot = ids[(ids >= 0) & (ids < H)]
    head = H if extra else int(torch.unique(hot).numel())
    return (ids.numel() * 8 + hot.numel() * C * 4 + 2 * head * C * 2
            + (H * C * 4 if extra else 0))


def check_hot(dev) -> dict:
    """Kernel 6 against its plain version at the [hot] path: a bf16
    [70,000, 400] table, H = 2048, one step's 8,208 float32 slab rows
    (subsampled Zipf(1.05) ids; no extra), and the -neg-stratify step's
    (the slab rows plus T*P*kh hot lanes, with the dense float32 `extra`).
    Both round the rows to bf16, sum each head row's rows in float32 in
    another order and round once, after the same head + extra rounding:
    atol 1e-5 + rtol 2^-7 (one bf16 rounding); every row past the head
    must be untouched; two launches on the same inputs are bit-equal."""
    from word2bits_tpu_torch.kernels.hot_pallas import (
        hot_plan, hot_slice_add_pallas, hot_slice_add_plain, tile_config)
    rng = np.random.default_rng(SEED + 6)
    V, C, H = SCATTER_V, 2 * D, HOT
    n_slab = B + 2 * W
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    table0 = (torch.rand((V, C), generator=gen, device=dev) - 0.5).to(
        torch.bfloat16)
    slab = torch.from_numpy(_step_ids(rng, V, n_slab, 0, 0)).to(dev)
    # hot lanes of -neg-stratify: kh of K per pool (the sampler's
    # lane_split of unigram^0.75) drawn from the hot stratum
    p_neg = np.arange(1, V + 1, dtype=np.float64) ** (-1.05 * 0.75)
    kh = min(K - 1, max(1, round(K * p_neg[:H].sum() / p_neg.sum())))
    lanes = torch.from_numpy(1 + rng.choice(
        H - 1, (B // G) * P * kh, p=p_neg[1:H] / p_neg[1:H].sum())).to(dev)
    cases = {}
    worst = 0.0
    for tag, ids, extra in (
            ("hot", slab, None),
            ("stratified, extra", torch.cat([slab, lanes]),
             torch.randn((H, C), generator=gen, device=dev) * 0.01)):
        rows = torch.randn((ids.numel(), C), generator=gen, device=dev) * 0.01
        got = hot_slice_add_pallas(table0.clone(), ids, rows, H, extra)
        again = hot_slice_add_pallas(table0.clone(), ids, rows, H, extra)
        want = hot_slice_add_plain(table0.clone(), ids, rows, H, extra)
        torch.cuda.synchronize()
        err = _max_err(got[:H], want[:H])
        if not torch.allclose(got[:H].float(), want[:H].float(), atol=1e-5,
                              rtol=2 ** -7):
            _fail(f"hot kernel ({tag}): max abs err {err:.3e} > atol 1e-5 + "
                  "rtol 2^-7")
        if not torch.equal(_bits(got), _bits(again)):
            _fail(f"hot kernel ({tag}): two launches on the same inputs "
                  "differ")
        if not torch.equal(got[H:], table0[H:]):
            _fail(f"hot kernel ({tag}) wrote rows past the head")
        hot = ids[(ids >= 0) & (ids < H)]
        n_hot = hot.numel()
        counts = torch.unique(hot, return_counts=True)[1]
        print(f"[hotk] {tag}: max abs err {err:.3e}; {ids.numel()} rows, "
              f"{n_hot} of them hot on {counts.numel()} head rows (longest "
              f"run {int(counts.max())}), into a [{H}, {C}] head; two "
              f"launches bit-equal")
        worst = max(worst, err)
        cases[tag] = (ids, rows, extra)
    # timed as the chunk calls it: the plan hoisted (its time apart)
    ids, rows, _ = cases["hot"]
    plan = hot_plan(ids, H)
    scratch = table0.clone()
    ms = _time_ms(lambda: hot_slice_add_pallas(scratch, ids, rows, H,
                                               plan=plan))
    plan_ms = _time_ms(lambda: hot_plan(ids, H))
    plain_ms = _time_ms(lambda: hot_slice_add_plain(scratch, ids, rows, H))
    keep = ids < H
    ids_in, rows_in = ids[keep], rows[keep].to(torch.bfloat16)
    library_ms = _time_ms(lambda: scratch.index_add_(0, ids_in, rows_in))
    nbytes = _hot_bytes(ids, H, C, False)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ids_s, rows_s, extra_s = cases["stratified, extra"]
    plan_s = hot_plan(ids_s, H)
    strat_ms = _time_ms(lambda: hot_slice_add_pallas(scratch, ids_s, rows_s,
                                                     H, extra_s, plan=plan_s))
    keep_s = ids_s < H
    ids_si, rows_si = ids_s[keep_s], rows_s[keep_s].to(torch.bfloat16)
    strat_library_ms = _time_ms(
        lambda: scratch.index_add_(0, ids_si, rows_si))
    strat_bytes = _hot_bytes(ids_s, H, C, True)
    strat_bound_ms = strat_bytes / HBM_BYTES_PER_S * 1e3
    cfg = tile_config()
    print(f"[hotk] kernel {ms:.5f} ms (one step's plan, hoisted to the "
          f"chunk's entry, {plan_ms:.5f} ms), plain {plain_ms:.5f} ms, "
          f"index_add_ of the hot rows {library_ms:.5f} ms, bound "
          f"{bound_ms:.5f} ms ({nbytes} bytes); stratified with extra "
          f"{strat_ms:.5f} ms (index_add_ {strat_library_ms:.5f} ms, bound "
          f"{strat_bound_ms:.5f} ms, {strat_bytes} bytes); tiles of "
          f"{cfg['L']} slots, {cfg['THREADS']} threads, chunks of "
          f"{cfg['SUB']} rows, {cfg['IB']} in flight, groups of at most "
          f"{cfg['GROUP']} columns")
    return dict(name="hot_slice_add_pallas", route="cuda",
                source="word2bits_tpu_torch/csrc/hot_slice.cu",
                replaces="word2bits_tpu/kernels/hot_pallas.py:84",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                plan_ms=plan_ms, stratified_extra_ms=strat_ms,
                stratified_extra_bound_ms=strat_bound_ms,
                stratified_extra_library_ms=strat_library_ms, config=cfg,
                shapes=f"table [{V}, {C}] bf16, H={H}, {ids.numel()} f32 "
                       f"rows ({int(keep.sum())} hot)")


def _hot_edge_ids(rng, L: int, H: int) -> dict:
    """Id sets at the edges of kernel 6's tiles (L slots) for a head of H
    rows: one head id holding 80% of 12,800 rows beside Zipf, cold and
    negative ids; runs of L - 1, L, L + 1 and 2L + 1 rows about the tile
    edges; cold and negative ids only; a few rows, so that most head rows
    have none (what `extra` must still fold); N = 0."""
    from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
    n = 12_800
    head = np.minimum(rng.zipf(1.3, n) - 1, 3000) + 10
    head[rng.random(n) < 0.8] = 5
    head[rng.choice(n, 64, replace=False)] = SENTINEL
    head[rng.choice(n, 16, replace=False)] = -1
    lens = [L, L - 1, 1, L + 1, 2 * L + 1, 3, L - 1, L, 2 * L + 1, L + 1]
    # the runs lead the sorted stream: their offsets from the tile edges
    # are set by `lens`; half the ids after them are cold
    runs = np.concatenate([np.repeat(np.arange(len(lens)), lens),
                           rng.integers(len(lens), 2 * H, 3000)])
    rng.shuffle(runs)
    cold = rng.choice(np.array([-4, -1, H, H + 9, SENTINEL]), 2000)
    few = rng.integers(0, H, 40)
    return {"head 80%": head, "runs about L": runs,
            "cold and negative only": cold, "40 rows": few,
            "N = 0": np.zeros(0, dtype=np.int64)}


def check_hot_edges(dev, widths=(37, 400, 1600)) -> None:
    """Kernel 6 at its tiles' edges (_hot_edge_ids) into the head of a
    [4096, C] table, H = 2,000 (not a multiple of the tile length), with
    and without a float32 `extra`, for each dtype pair (a bf16 table with
    float32 and with bf16 rows, a float32 table) at widths 37 (one column a
    thread), 400 and 1,600: two launches bit-equal; rows past the head
    untouched; held against the plain version at [hotk]'s tolerance (atol
    1e-5 + rtol 2^-7); and every head row that no row reaches equal to the
    plain version's (with `extra`: folded once, round(table + extra);
    without: as it was)."""
    from word2bits_tpu_torch.kernels.hot_pallas import (
        hot_slice_add_pallas, hot_slice_add_plain, tile_config)
    L = tile_config()["L"]
    rng = np.random.default_rng(SEED + 10)
    V, H = 4096, 2000
    worst = 0.0
    cases = _hot_edge_ids(rng, L, H)
    for what, ids_np in cases.items():
        ids = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
        hot = ids[(ids >= 0) & (ids < H)]
        empty = torch.ones(H, dtype=torch.bool, device=dev)
        empty[hot] = False
        for C in widths:
            gen = torch.Generator(device=dev).manual_seed(SEED + C)
            rows = torch.randn((ids.numel(), C), generator=gen,
                               device=dev) * 0.01
            base = torch.rand((V, C), generator=gen, device=dev) - 0.5
            ext = torch.randn((H, C), generator=gen, device=dev) * 0.1
            for tdt, rdt in ((torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.float32)):
                table0, r = base.to(tdt), rows.to(rdt)
                for extra in (None, ext):
                    k6 = [hot_slice_add_pallas(table0.clone(), ids, r, H,
                                               extra) for _ in range(2)]
                    plain = hot_slice_add_plain(table0.clone(), ids, r, H,
                                                extra)
                    torch.cuda.synchronize()
                    tag = (f"{what}, {str(tdt)[6:]} table, {str(rdt)[6:]} "
                           f"rows, width {C}, "
                           f"{'extra' if extra is not None else 'no extra'}")
                    if not torch.equal(_bits(k6[0]), _bits(k6[1])):
                        _fail(f"hot edges ({tag}): two launches not "
                              f"bit-equal, max abs err "
                              f"{_max_err(k6[0], k6[1]):.3e}")
                    if not torch.equal(_bits(k6[0][H:]), _bits(table0[H:])):
                        _fail(f"hot edges ({tag}): rows past the head "
                              "changed")
                    if not torch.equal(k6[0][:H][empty], plain[:H][empty]):
                        _fail(f"hot edges ({tag}): a head row that no row "
                              "reaches differs from the plain version")
                    err = _max_err(k6[0][:H], plain[:H])
                    if not torch.allclose(k6[0][:H].float(),
                                          plain[:H].float(), atol=1e-5,
                                          rtol=2 ** -7):
                        _fail(f"hot edges ({tag}): max abs err {err:.3e} "
                              "against the plain version > atol 1e-5 + "
                              "rtol 2^-7")
                    worst = max(worst, err)
    print(f"[hot edges] tiles of {L} slots, H = {H} of a [{V}, C] table; "
          f"{', '.join(cases)} at widths {', '.join(map(str, widths))} in 3 "
          f"dtype pairs, with and without extra: two launches bit-equal, "
          f"head rows no row reaches equal to the plain version's, max abs "
          f"err {worst:.3e} against the plain version")


# ---------------------------------------------------------------- kernel 8
def _rmw_allowed(want: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                 touched: torch.Tensor) -> torch.Tensor:
    """[rmwk]'s tolerance on the touched rows (in `touched`'s order): two
    bf16 roundings of the value and of the sums that entered it,
    2^-6 (|want| + A) + 1e-6, A the per-id sum of |rows|."""
    keep = (ids >= 0) & (ids < want.shape[0])
    slot = torch.searchsorted(touched, ids[keep])
    mags = torch.zeros((touched.numel(), rows.shape[1]), device=rows.device)
    mags.index_add_(0, slot, rows[keep].float().abs())
    return 2 ** -6 * (want[touched].float().abs() + mags) + 1e-6


def check_rmw(dev) -> dict:
    """Kernel 8 against its plain version at the capacity shape: two
    copies of one random bf16 [3,699,941, 1,600] table, one step's two
    calls (16,400 float32 slab rows of subsampled Zipf(1.05) ids, then
    6,144 negative rows of unigram^0.75 ids, 64 drop sentinels each).
    Both sum each id's bf16-rounded rows in float32 in another order,
    round the sum, and add it with one rounding, twice: a touched value may
    differ by two bf16 roundings of itself and of the sums that entered it
    (|got - want| <= 2^-6 (|want| + A) + 1e-6, A the per-id sum of |rows|);
    every other row must be untouched in both; the two calls run twice on
    the same inputs give bit-equal rows."""
    from word2bits_tpu_torch.kernels.scatter_pallas import (
        scatter_add_rmw, scatter_add_rmw_plain, scatter_add_rmw_planned,
        tile_config)
    from word2bits_tpu_torch.kernels.span_scatter import SENTINEL, sort_plan
    rng = np.random.default_rng(SEED + 8)
    V, C = FLAG_V, 2 * FLAG_D
    n_slab, n_neg = RMW_N
    both = _step_ids(rng, V, n_slab, n_neg, 0)
    calls = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for ids in (both[:n_slab].copy(), both[n_slab:].copy()):
        ids[rng.choice(ids.size, 64, replace=False)] = SENTINEL
        ids = torch.from_numpy(ids).to(dev)
        rows = torch.randn((ids.numel(), C), generator=gen, device=dev) * 0.01
        calls.append((ids, rows))
    got = torch.empty((V, C), dtype=torch.bfloat16, device=dev)
    got.uniform_(-0.5, 0.5, generator=torch.Generator(
        device=dev).manual_seed(SEED + 9))
    want = got.clone()
    all_ids = torch.cat([c[0] for c in calls])
    touched = torch.unique(all_ids[all_ids < V])
    before = got[touched]
    for ids, rows in calls:
        scatter_add_rmw(got, ids, rows)
        scatter_add_rmw_plain(want, ids, rows)
    first = got[touched]
    got[touched] = before                       # and once more
    for ids, rows in calls:
        scatter_add_rmw(got, ids, rows)
    torch.cuda.synchronize()
    if not torch.equal(_bits(first), _bits(got[touched])):
        _fail("rmw: two launches on the same inputs differ")
    del before, first
    g, w = got[touched].float(), want[touched].float()
    err = _max_err(g, w)
    allowed = _rmw_allowed(want, all_ids, torch.cat([c[1] for c in calls]),
                           touched)
    if not bool(((g - w).abs() <= allowed).all()):
        _fail(f"rmw: max abs err {err:.3e} on the touched rows beyond two "
              "bf16 roundings")
    del g, w, allowed
    untouched = torch.ones(V, dtype=torch.bool, device=dev)
    untouched[touched] = False
    step = 1 << 18
    for r0 in range(0, V, step):
        m = untouched[r0:r0 + step]
        if not torch.equal(got[r0:r0 + step][m], want[r0:r0 + step][m]):
            _fail(f"rmw wrote rows it was not given (rows {r0}..)")
    runs, longest = [], []
    for ids, _ in calls:
        counts = torch.unique(ids[ids < V], return_counts=True)[1]
        runs.append(counts.numel())
        longest.append(int(counts.max()))
    cfg = tile_config()
    print(f"[rmwk] max abs err {err:.3e}; calls of {n_slab} and {n_neg} "
          f"rows, {runs[0]} and {runs[1]} runs (distinct ids; "
          f"{touched.numel()} over both), longest {longest[0]} and "
          f"{longest[1]} rows; two launches bit-equal; tiles of {cfg['L']} "
          f"slots, {cfg['THREADS']} threads, chunks of {cfg['SUB']} rows, "
          f"{cfg['IB']} in flight, groups of at most {cfg['GROUP']} columns")
    # kernel 8 reads each call's sorted ids and source rows
    plans = [sort_plan(ids) for ids, _ in calls]

    def kernel():
        for (ids, rows), pl in zip(calls, plans):
            scatter_add_rmw_planned(got, pl, rows)

    def plain():
        for ids, rows in calls:
            scatter_add_rmw_plain(want, ids, rows)
    inside = [(ids[ids < V], rows[ids < V].to(torch.bfloat16))
              for ids, rows in calls]

    def library():
        for ids, rows in inside:
            got.index_add_(0, ids, rows)
    ms = _time_ms(kernel)
    plan_ms = _time_ms(lambda: [sort_plan(ids) for ids, _ in calls])
    plain_ms = _time_ms(plain)
    library_ms = _time_ms(library)
    # bytes, both calls: the rows, the sorted ids and their source rows
    # read once; each touched row read and written once per call
    nbytes = sum(rows.numel() * 4 + 2 * ids.numel() * 4 + 2 * nt * C * 2
                 for (ids, rows), nt in zip(calls, runs))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[rmwk] one step's two calls: kernel {ms:.5f} ms (the two sorts "
          f"{plan_ms:.5f} ms), plain {plain_ms:.5f} ms, index_add_ "
          f"{library_ms:.5f} ms, bound {bound_ms:.5f} ms ({nbytes} bytes)")
    del got, want
    torch.cuda.empty_cache()
    return dict(name="scatter_add_rmw", route="cuda",
                source="word2bits_tpu_torch/csrc/group_rmw.cu",
                replaces="word2bits_tpu/kernels/scatter_pallas.py:178",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                plan_ms=plan_ms, config=cfg,
                shapes=f"table [{V}, {C}] bf16, {n_slab} + {n_neg} f32 "
                       "rows (one step's two calls)")


def _rmw_rounding_case(L: int) -> tuple:
    """Ids and rows (C columns alike) where an id's rounded sum differs
    from the sum of its rounded pieces: id 0 leads the sorted stream with
    2L rows, cut once by a tile edge; its first tile's piece sums to
    1 + 2^-8 (bf16 rounds that to 1), its second's to 2^-8, the whole to
    1 + 2^-7 (a bf16 value).  So at a zero bf16 row the one rounding of
    the sum gives 1 + 2^-7 and rounding the pieces would give 1."""
    ids = np.concatenate([np.zeros(2 * L, dtype=np.int64),
                          np.arange(1, 201, dtype=np.int64)])
    vals = np.zeros(ids.size, dtype=np.float32)
    vals[0], vals[1], vals[L] = 1.0, 2.0 ** -8, 2.0 ** -8
    vals[2 * L:] = 0.5
    return ids, vals


def check_rmw_edges(dev, widths=(37, 200, 1600)) -> None:
    """Kernel 8 at its tiles' edges, as [grmw edges] for kernel 7
    (_grmw_edge_plans at kernel 8's tile length: one id holding 80% of
    12,800 rows, one id holding all, N below one tile, drop sentinels and
    negative ids only, N = 0) and an id whose rounded sum differs from the
    sum of its rounded pieces (_rmw_rounding_case), for each dtype pair at
    widths 37 (one column a thread), 200 and 1,600: two launches
    bit-equal; ids outside [0, V) dropped (a plan of them only leaves the
    table as it was); held against the plain version at [rmwk]'s tolerance;
    the rounding case's id bit-equal to the plain version (one rounding of
    its whole sum)."""
    from word2bits_tpu_torch.kernels.scatter_pallas import (
        scatter_add_rmw, scatter_add_rmw_plain, tile_config)
    L = tile_config()["L"]
    rng = np.random.default_rng(SEED + 11)
    V = 4096
    plans = _grmw_edge_plans(rng, L)
    r_ids, r_vals = _rmw_rounding_case(L)
    plans["rounded sum"] = r_ids
    worst = 0.0
    for what, ids_np in plans.items():
        ids = torch.from_numpy(ids_np).to(dev)
        keep = (ids >= 0) & (ids < V)
        touched = torch.unique(ids[keep])
        for C in widths:
            gen = torch.Generator(device=dev).manual_seed(SEED + C)
            rows = torch.randn((ids.numel(), C), generator=gen,
                               device=dev) * 0.01
            base = torch.rand((V, C), generator=gen, device=dev) - 0.5
            if what == "rounded sum":
                rows = torch.from_numpy(r_vals).to(dev)[:, None].expand(
                    -1, C).contiguous()
                base[0] = 0.0
            for tdt, rdt in ((torch.bfloat16, torch.float32),
                             (torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.float32)):
                table0, r = base.to(tdt), rows.to(rdt)
                k8 = [scatter_add_rmw(table0.clone(), ids, r)
                      for _ in range(2)]
                plain = scatter_add_rmw_plain(table0.clone(), ids, r)
                torch.cuda.synchronize()
                tag = (f"{what}, {str(tdt)[6:]} table, {str(rdt)[6:]} rows, "
                       f"width {C}")
                if not torch.equal(_bits(k8[0]), _bits(k8[1])):
                    _fail(f"rmw edges ({tag}): two launches not bit-equal, "
                          f"max abs err {_max_err(k8[0], k8[1]):.3e}")
                untouched = torch.ones(V, dtype=torch.bool, device=dev)
                untouched[touched] = False
                if not torch.equal(_bits(k8[0][untouched]),
                                   _bits(table0[untouched])):
                    _fail(f"rmw edges ({tag}): a row it was not given "
                          "changed")
                if touched.numel() == 0:
                    continue
                g, w = k8[0][touched].float(), plain[touched].float()
                err = _max_err(g, w)
                allowed = _rmw_allowed(plain, ids, r, touched)
                if not bool(((g - w).abs() <= allowed).all()):
                    _fail(f"rmw edges ({tag}): max abs err {err:.3e} "
                          "against the plain version beyond two roundings")
                worst = max(worst, err)
                if what == "rounded sum" and not torch.equal(
                        _bits(k8[0][0]), _bits(plain[0])):
                    _fail(f"rmw edges ({tag}): id 0 is {k8[0][0][0]}, the "
                          f"plain version {plain[0][0]} (one rounding of "
                          "the whole sum)")
    print(f"[rmw edges] tiles of {L} slots; {', '.join(plans)} at widths "
          f"{', '.join(map(str, widths))} in 3 dtype pairs: two launches "
          f"bit-equal, rows not given untouched, the rounded-sum id "
          f"bit-equal to the plain version; max abs err {worst:.3e} "
          f"against the plain version")


# ---------------------------------------------------------------- kernel 4
def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float32 or bfloat16 tensor (-0.0 is not +0.0)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _sorted_runs(plan, V: int):
    """(distinct ids in [0, V), longest run of one of them) of a sort
    plan."""
    s = plan.sids
    _, n = torch.unique_consecutive(s[(s >= 0) & (s < V)],
                                    return_counts=True)
    return n.numel(), int(n.max()) if n.numel() else 0


def _digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's raw bits, row-major (its first 16 hex
    digits): equal digests mean bit-equal tensors."""
    raw = _bits(t.contiguous()).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def check_quantize(dev) -> dict:
    """quantize_pallas against quantize_pallas_plain on the card, bit for
    bit (max abs err 0, -0.0 told from +0.0): one export block of the
    capacity configuration (20,971 x 800 float32, the u + v sum the export
    quantizes) at bitlevels 0, 1, 2, 4, 8; a 70,000 x 400 bfloat16 table
    at bitlevels 1, 4, 8, 9 (every intermediate rounded to bfloat16); and
    once the whole 3,699,941 x 800 float32 sum (23.7 GB of traffic),
    compared block by block.  Timed: the export block, the bf16 table, the
    whole sum, and the export's 177 blocks one after another through the
    kernel and through the plain version."""
    from word2bits_tpu_torch.kernels.quantize_pallas import (
        quantize_pallas, quantize_pallas_plain)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    special = torch.tensor([0.0, -0.0, 0.5, -0.5, 0.25, -0.75, 1.0, -1.5,
                            1 / 16, -1 / 16, 200.5, -127.5], device=dev)

    def case(x, bl, tag) -> None:
        got = quantize_pallas(x, bl)
        want = quantize_pallas_plain(x, bl)
        torch.cuda.synchronize()
        if got.dtype != x.dtype or not torch.equal(_bits(got), _bits(want)):
            _fail(f"quantize kernel ({tag}, bitlevel {bl}): max abs err "
                  f"{_max_err(got, want):.3e}, {int((_bits(got) != _bits(want)).sum())} "
                  "values differ from the plain version")
        print(f"[quantk] {tag} bitlevel {bl}: bit-equal to the plain version "
              f"({x.numel()} values)")

    blk = torch.rand((EXPORT_ROWS, FLAG_D), generator=gen, device=dev) * 4 - 2
    blk.view(-1)[:special.numel()] = special
    for bl in (0, 1, 2, 4, 8):
        case(blk, bl, f"[{EXPORT_ROWS}, {FLAG_D}] f32")
    b16 = (torch.rand((SCATTER_V, 2 * D), generator=gen, device=dev) * 4
           - 2).to(torch.bfloat16)
    b16.view(-1)[:special.numel()] = special.to(torch.bfloat16)
    for bl in (1, 4, 8, 9):
        case(b16, bl, f"[{SCATTER_V}, {2 * D}] bf16")
    ms = _time_ms(lambda: quantize_pallas(blk, 1))
    plain_ms = _time_ms(lambda: quantize_pallas_plain(blk, 1))
    bound_ms = 2 * blk.numel() * 4 / HBM_BYTES_PER_S * 1e3
    ms16 = _time_ms(lambda: quantize_pallas(b16, 9))
    plain16 = _time_ms(lambda: quantize_pallas_plain(b16, 9))
    bound16 = 2 * b16.numel() * 2 / HBM_BYTES_PER_S * 1e3

    # the whole capacity sum: 11.84 GB in, 11.84 GB out
    whole = torch.empty((FLAG_V, FLAG_D), device=dev)
    whole.uniform_(-2.0, 2.0, generator=gen)
    out = quantize_pallas(whole, 1)
    torch.cuda.synchronize()
    for r0 in range(0, FLAG_V, EXPORT_ROWS):
        part = whole[r0:r0 + EXPORT_ROWS]
        if not torch.equal(_bits(out[r0:r0 + EXPORT_ROWS]),
                           _bits(quantize_pallas_plain(part, 1))):
            _fail(f"quantize kernel on the whole sum: rows {r0}.. differ "
                  "from the plain version")
    del out
    whole_ms = _time_ms(lambda: quantize_pallas(whole, 1), reps=3,
                        warmup=1)
    whole_bound = 2 * whole.numel() * 4 / HBM_BYTES_PER_S * 1e3

    def blocks(fn):
        for r0 in range(0, FLAG_V, EXPORT_ROWS):
            fn(whole[r0:r0 + EXPORT_ROWS], 1)
    blocks_ms = _time_ms(lambda: blocks(quantize_pallas), reps=2, warmup=1)
    blocks_plain = _time_ms(lambda: blocks(quantize_pallas_plain), reps=2,
                            warmup=1)
    del whole
    torch.cuda.empty_cache()
    print(f"[quantk] export block: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms; bf16 [{SCATTER_V}, {2 * D}] at "
          f"bitlevel 9: kernel {ms16:.4f} ms, plain {plain16:.4f} ms, bound "
          f"{bound16:.4f} ms; the whole [{FLAG_V}, {FLAG_D}] sum: kernel "
          f"{whole_ms:.3f} ms, bound {whole_bound:.3f} ms (bit-equal to the "
          f"plain version); the export's {EXPORT_BLOCKS} blocks in turn: "
          f"kernel {blocks_ms:.2f} ms, plain {blocks_plain:.2f} ms")
    return dict(name="quantize_pallas", route="cuda",
                source="word2bits_tpu_torch/csrc/quantize.cu",
                replaces="word2bits_tpu/kernels/quantize_pallas.py:57",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                bf16=dict(ms=ms16, plain_ms=plain16, bound_ms=bound16,
                          shapes=f"[{SCATTER_V}, {2 * D}] bf16, bitlevel 9"),
                whole_ms=whole_ms, whole_bound_ms=whole_bound,
                export_blocks_ms=blocks_ms,
                export_blocks_plain_ms=blocks_plain,
                shapes=f"[{EXPORT_ROWS}, {FLAG_D}] f32 (one export block), "
                       "bitlevel 1")


# ---------------------------------------------------------------- kernel 9
def check_sweep(dev) -> dict:
    """The sweep scatter against scatter_add_sweep_plain on the card at
    kernel 2's shape ([span]: the same 14,352 float32 rows, Zipf ids with
    drop sentinels, into the same bf16 [70,000, 400] table), window 512,
    chunk 128.  Both sum each (block, id) run in float32 in slot order and
    add it with one rounding, the blocks in order: bit-equal.  index_add_
    of the same rows (in range, bf16) is the library yardstick."""
    from word2bits_tpu_torch.kernels.sweep_scatter import (
        scatter_add_sweep_plain, scatter_add_sweep_planned, sweep_plan)
    rng = np.random.default_rng(SEED)
    V, C, N = SCATTER_V, 2 * D, SCATTER_N
    ids = torch.from_numpy(_step_ids(rng, V, B + 2 * W, N - B - 2 * W,
                                     64)).to(dev)
    rows = (torch.randn((N, C), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 0.01)
    table0 = (torch.rand((V, C), generator=torch.Generator(
        device=dev).manual_seed(SEED + 1), device=dev) - 0.5).to(
        torch.bfloat16)
    plan = sweep_plan(ids, V)
    got = scatter_add_sweep_planned(table0.clone(), plan, rows)
    want = scatter_add_sweep_plain(table0.clone(), ids, rows)
    torch.cuda.synchronize()
    err = _max_err(got, want)
    if not torch.equal(_bits(got), _bits(want)):
        _fail(f"sweep scatter: max abs err {err:.3e}, not bit-equal to the "
              "plain version")
    if torch.equal(got, table0):
        _fail("sweep scatter changed nothing")
    n_unique = int(torch.unique(ids[ids < V]).numel())
    wc = plan.win_chunk.long()
    per_win = wc[1:] - wc[:-1]
    print(f"[sweepk] bit-equal to the plain version; {N} rows, {n_unique} "
          f"distinct ids, {int((per_win > 0).sum())} windows touched, "
          f"{int(wc[-1])} blocks of 128 slots, the busiest window "
          f"{int(per_win.max())} blocks")
    scratch = table0.clone()
    ms = _time_ms(lambda: scatter_add_sweep_planned(scratch, plan, rows))
    plan_ms = _time_ms(lambda: sweep_plan(ids, V))
    plain_ms = _time_ms(lambda: scatter_add_sweep_plain(scratch, ids, rows),
                        reps=5, warmup=1)
    keep = ids < V
    ids_in, rows_in = ids[keep], rows[keep].to(torch.bfloat16)
    library_ms = _time_ms(lambda: scratch.index_add_(0, ids_in, rows_in))
    # bytes: rows and the plan the kernel reads (slot rows, offsets, window
    # starts) read once; each touched table row read and written once
    nbytes = (rows.numel() * 4
              + sum(t.numel() * 4 for t in (plan.order, plan.offs,
                                            plan.win_chunk))
              + 2 * n_unique * C * 2)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[sweepk] kernel {ms:.4f} ms (its plan, built per step, "
          f"{plan_ms:.4f} ms), plain {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    return dict(name="scatter_add_sweep", route="cuda",
                source="word2bits_tpu_torch/csrc/sweep_scatter.cu",
                replaces="word2bits_tpu/kernels/sweep_scatter.py:111",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                plan_ms=plan_ms,
                shapes=f"table [{V}, {C}] bf16, {N} f32 rows, window 512, "
                       "chunk 128")


def _sweep_edge_ids(rng) -> tuple:
    """(ids, V) of a sweep plan with the kernel's edges (window 512, chunk
    128, V = 4,096: eight windows): in window 0, id 5 takes 400 rows after
    three single ids, so its rows span four blocks (two of them whole);
    window 1 is one full block of id 519 (offset 7), and window 2 starts
    with id 1,031 (offset 7 again, another row); windows 3-6 hold random
    ids; window 7 holds none, so the plan's padding blocks at the end fall
    in a window of padding only; 20 drop sentinels."""
    from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
    V = 4096
    ids = np.concatenate([
        [1, 2, 3], np.full(400, 5), rng.integers(6, 512, 100),
        np.full(128, 519), np.full(3, 1031), rng.integers(1032, 1536, 200),
        rng.integers(1536, 3584, 600), np.full(20, SENTINEL)])
    rng.shuffle(ids)
    return ids.astype(np.int64), V


def check_sweep_edges(dev) -> None:
    """Kernel 9 bit-equal to scatter_add_sweep_plain on _sweep_edge_ids's
    plan (an id over four blocks, a window that ends on a block edge
    followed by the same offset in the next window, a window of padding
    only), for a bf16 table with float32 and with bf16 rows and a float32
    table, width 400; and a float32 table 4,100 wide, whose walks are split
    over two CTAs by columns (wider than one CTA's shared segment sums)."""
    from word2bits_tpu_torch.kernels.sweep_scatter import (
        scatter_add_sweep_plain, scatter_add_sweep_planned, sweep_plan)
    rng = np.random.default_rng(SEED + 9)
    ids_np, V = _sweep_edge_ids(rng)
    ids = torch.from_numpy(ids_np).to(dev)
    plan = sweep_plan(ids, V)
    offs = plan.offs.reshape(-1, 128).long().cpu()
    meta = plan.meta.long().cpu()
    blocks_of_5 = int((offs == 5).any(dim=1)[meta == 0].sum())
    pad_win = [w for w in range(-(-V // 512))
               if (meta == w).any() and bool((offs[meta == w] < 0).all())]
    if blocks_of_5 < 3 or not pad_win:
        _fail(f"sweep edge plan: id 5 spans {blocks_of_5} blocks, windows of "
              f"padding only {pad_win}")
    for tdt, rdt, C in ((torch.bfloat16, torch.float32, 2 * D),
                        (torch.bfloat16, torch.bfloat16, 2 * D),
                        (torch.float32, torch.float32, 2 * D),
                        (torch.float32, torch.float32, 4100)):
        rows = (torch.randn((ids.numel(), C), generator=torch.Generator(
            device=dev).manual_seed(SEED + 2), device=dev) * 0.01).to(rdt)
        table0 = (torch.rand((V, C), generator=torch.Generator(
            device=dev).manual_seed(SEED + 3), device=dev) - 0.5).to(tdt)
        got = scatter_add_sweep_planned(table0.clone(), plan, rows)
        want = scatter_add_sweep_plain(table0.clone(), ids, rows)
        torch.cuda.synchronize()
        if not torch.equal(_bits(got), _bits(want)):
            _fail(f"sweep scatter edges ({tdt} table, {rdt} rows, width "
                  f"{C}): max abs err {_max_err(got, want):.3e}, not "
                  "bit-equal")
    print(f"[sweepk edges] bit-equal in 3 dtype pairs at width 400 and "
          f"float32 at 4,100: {ids.numel()} rows, "
          f"{offs.shape[0]} blocks, id 5 over {blocks_of_5} blocks, window "
          f"{pad_win} of padding only")


# ------------------------------------------------------- step and chunk
def _step_cases() -> tuple:
    """check_step_and_chunk's configurations at its small shape, float32
    tables: (data, cases) with each case (name, fused, neg_sharing, kind,
    with_map, kwargs, negs), its injected negatives drawn in order."""
    from word2bits_tpu_torch.data.pipeline import cold_positions
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.sampling.unigram import build_stratified_tables
    rng = np.random.default_rng(SEED + 1)
    v, d, b, w, k, g, p, s, h = 300, 16, 64, 3, 5, 8, 2, 3, 32
    hyper = CBOWHyper(bitlevel=1, size=d, window=w, negative=k)
    n = s * b + 2 * w + 10
    tokens = torch.from_numpy(rng.integers(0, v, n))
    tokens[rng.integers(0, n, n // 3)] = torch.from_numpy(
        rng.integers(0, h, n // 3))                  # hot ids in every slab
    tokens[:w] = -1
    sents = torch.arange(n) // 23
    sents[:w] = -1
    shrinks = torch.from_numpy(rng.integers(0, w, (s, b)))
    u0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (v, d)).astype(np.float32))
    v0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (v, d)).astype(np.float32))
    sc = ChunkScalars(base0=w, alpha0=0.05, wca_start=100.0,
                      wca_per_step=float(b), denom=1e4)
    st = build_stratified_tables(np.arange(v, 0, -1.0) ** 0.75, h)
    strat = st.lane_split(k)
    dense = st.dense_split(k)
    cold = torch.from_numpy(cold_positions(tokens.numpy(), b, w, s, h)).long()
    fused_kw = dict(banded=8, neg_pool=p, context_pallas=True)
    hot_kw = dict(banded=8, neg_pool=p, hot_rows=h)
    # (name, fused, neg_sharing, negatives, cold map, kwargs)
    configs = (
        ("span", True, g, "plain", False,
         dict(fused_kw, scatter_impl="span")),
        ("sweep", True, g, "plain", False,
         dict(fused_kw, scatter_impl="sweep")),
        ("grmw", True, g, "plain", False,
         dict(fused_kw, scatter_impl="grmw")),
        ("quickstart", False, 0, "plain", False, dict(banded=0)),
        ("exact", False, 0, "plain", False,
         dict(banded=8, scatter_impl="span", context_pallas=True)),
        ("exact rank-1", False, 0, "plain", False,
         dict(banded=8, scatter_impl="span", context_pallas=True,
              span_rank1=True)),
        ("pallas split", False, g, "plain", False,
         dict(banded=8, neg_pool=p, use_pallas=True, context_pallas=True)),
        ("pallas fused", True, g, "plain", False,
         dict(banded=8, neg_pool=p, use_pallas=True, context_pallas=True)),
        ("hot", True, g, "plain", True, dict(hot_kw)),
        ("hot, hot_pallas", True, g, "plain", True,
         dict(hot_kw, hot_pallas=True, context_pallas=True)),
        ("hot, use_pallas", True, g, "plain", True,
         dict(hot_kw, hot_pallas=True, use_pallas=True)),
        ("stratified", True, g, "strat", True,
         dict(hot_kw, hot_pallas=True, strat_lanes=strat)),
        ("dense-hot", True, g, "dense", True,
         dict(hot_kw, hot_pallas=True, dense_hot=dense)),
        ("dense-hot, no cold map", True, g, "dense", False,
         dict(hot_kw, hot_pallas=True, dense_hot=dense)),
        ("rmw", True, g, "plain", False,
         dict(fused_kw, rmw_scatter=True)),
        ("dedup fused", True, g, "plain", False,
         dict(banded=8, neg_pool=p, dedup_block=64)),
        ("dedup split", False, 0, "plain", False,
         dict(banded=0, dedup_block=64)),
    )
    cases = []
    for name, fused, gg, kind, with_map, kw in configs:
        T = b // gg if gg else b
        if kind == "strat":
            kh = strat[0]
            negs = torch.from_numpy(np.concatenate(
                [rng.integers(1, h, (s, T, p, kh)),
                 rng.integers(h, v, (s, T, p, k - kh))], axis=3)
                .reshape(s, T, p * k))
        elif kind == "dense":
            negs = torch.from_numpy(rng.integers(h, v, (s, T, p * dense[0])))
        else:
            negs = torch.from_numpy(rng.integers(
                1, v, (s, T, p * k) if gg else (s, b, k)))
        cases.append((name, fused, gg, kind, with_map, kw, negs))
    data = dict(hyper=hyper, tokens=tokens, sents=sents, shrinks=shrinks,
                u0=u0, v0=v0, sc=sc, st=st, dense=dense, cold=cold, v=v,
                b=b, w=w, s=s)
    return data, cases


def _run_step_case(data: dict, case: tuple, where, what=("step", "chunk")):
    """One step and/or the 3-step chunk of a _step_cases case on device
    `where`, each from the same state and injected draws: {what: (tables,
    loss)} with the tables on `where`."""
    from word2bits_tpu_torch.models import cbow_fused as cf
    from word2bits_tpu_torch.models import cbow_slab as cs
    from word2bits_tpu_torch.sampling.unigram import build_alias_table
    name, fused, gg, kind, with_map, kw, negs = case
    hyper, tokens, sents = data["hyper"], data["tokens"], data["sents"]
    shrinks, u0, v0, st = data["shrinks"], data["u0"], data["v0"], data["st"]
    dense, v, b, w, s = data["dense"], data["v"], data["b"], data["w"], \
        data["s"]
    st_in = cs.SlabInputs(
        tokens[:b + 2 * w].to(where), sents[:b + 2 * w].to(where),
        shrinks[0].to(where), negs[0].to(where))
    alpha = torch.tensor(0.05, device=where)
    if kind == "strat":
        atab = (st.hot.to(where), st.cold.to(where))
    elif kind == "dense":
        atab = st.cold.to(where)
    else:
        atab = build_alias_table(np.ones(v)).to(where)
    chunk_data = (tokens.to(where), sents.to(where), atab, data["sc"])
    draws = dict(shrinks=shrinks.to(where), negs=negs.to(where))
    step_kw = dict(kw)
    if with_map:
        step_kw["cold_pos"] = data["cold"][0].to(where)
        draws["cold_pos"] = data["cold"].to(where)
    if kind == "dense":
        step_kw["dense_hot"] = (dense[1], torch.from_numpy(
            dense[2]).to(where))
    out = {}
    if fused:
        t0 = torch.cat([u0, v0], dim=1).to(where)
        if "step" in what:
            tab, loss = cf.fused_slab_step(t0.clone(), st_in, alpha, hyper,
                                           b, gg, **step_kw)
            out["step"] = ((tab,), loss)
        if "chunk" in what:
            chunk = cf.make_fused_train_chunk(hyper, v, b, s, gg, **kw)
            ctab, closs = chunk(t0.clone(), *chunk_data, **draws)
            out["chunk"] = ((ctab,), closs)
    else:
        if "step" in what:
            su, sv, loss = cs.slab_step(u0.clone().to(where),
                                        v0.clone().to(where), st_in, alpha,
                                        hyper, b, gg, **step_kw)
            out["step"] = ((su, sv), loss)
        if "chunk" in what:
            chunk = cs.make_slab_train_chunk(hyper, v, b, s, gg, **kw)
            cu, cv, closs = chunk(u0.clone().to(where), v0.clone().to(where),
                                  *chunk_data, **draws)
            out["chunk"] = ((cu, cv), closs)
    return out


def check_step_and_chunk(dev) -> None:
    """One step and a 3-step chunk of each engine on the card (kernels)
    against the same calls on the CPU (plain versions), at a small shape
    with injected draws, float32 tables: atol 1e-4 + rtol 1e-4, loss rtol
    1e-5.  Configurations (_step_cases): the fused table with the span
    scatter, with the sweep scatter (kernel 9) and with grmw (context
    kernel); the split tables at the Quick start (per-center, shifted sums, add) and in the exact mode with
    materialized and with rank-1 negative rows (span, banded, context
    kernel); the score kernel on split and on fused tables; the hot/cold
    split (with and without kernel 6, and with the score kernel), the
    stratified lanes, the dense hot stratum with and without a cold map;
    the RMW scatter (kernel 8); the block dedup on both engines."""
    data, cases = _step_cases()
    for case in cases:
        name = case[0]
        outs = {}
        for where in ("cpu", dev):
            run = _run_step_case(data, case, where)
            (step, loss), (chunked, closs) = run["step"], run["chunk"]
            outs[str(where)] = ([t.cpu() for t in step], float(loss),
                                [t.cpu() for t in chunked], float(closs))
        (t0_, l0, c0, cl0), (t1, l1, c1, cl1) = outs["cpu"], outs[str(dev)]
        errs = []
        for what, a, bb in (("step", t1, t0_), ("chunk", c1, c0)):
            for x, y in zip(a, bb):
                if not torch.allclose(x, y, atol=1e-4, rtol=1e-4):
                    _fail(f"{name} {what} on the card vs the CPU: max abs "
                          f"err {_max_err(x, y):.3e}")
                errs.append(_max_err(x, y))
        for what, a, bb in (("step loss", l1, l0), ("chunk loss", cl1, cl0)):
            if abs(a - bb) > 1e-5 * abs(bb) + 1e-6:
                _fail(f"{name} {what} on the card {a} vs the CPU {bb}")
        print(f"[step] {name} card vs CPU: step and chunk max abs err "
              f"{max(errs):.3e}, losses {l1:.6f}/{l0:.6f}, "
              f"{cl1:.6f}/{cl0:.6f}")


# ------------------------------------------------- [train]: shipped path
def train_main_path(work: str):
    """`cli train` on a synthetic text8-like corpus at the shipped flags;
    returns its launch counts, the vector file and the corpus."""
    from word2bits_tpu_torch import cli
    from word2bits_tpu_torch.data.synthetic import zipf_corpus
    from word2bits_tpu_torch.io.vectors import read_vectors

    corpus = os.path.join(work, "corpus.txt")
    out = os.path.join(work, "vecs.bin")
    t0 = time.perf_counter()
    zipf_corpus(corpus, n_tokens=CORPUS_TOKENS, vocab=CORPUS_TYPES, seed=SEED)
    print(f"[train] corpus of {CORPUS_TOKENS} tokens written in "
          f"{time.perf_counter() - t0:.1f} s")

    captured = io.StringIO()
    _zero_launches()
    with contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
        rc = cli.train_main(["-train", corpus, "-output", out] + TRAIN_FLAGS)
    launches = _read_launches()
    if rc != 0:
        _fail(f"cli train returned {rc}")
    log = captured.getvalue()
    m = re.search(r"Trained (\d+) steps in ([0-9.]+) s: ([0-9.]+) "
                  r"words/sec, ([0-9.]+) us/step", log)
    losses = [float(x) for x in re.findall(r"Epoch Loss: (\S+)", log)]
    if not m or not losses:
        _fail("cli train printed no step count or no epoch loss")
    steps = int(m.group(1))
    if steps < S:
        _fail(f"trained {steps} steps, fewer than one {S}-step chunk")
    path = re.search(r"Epochs built on the (\w+)", log)
    epochs = re.search(r"Epoch arrays \(\w+\): ([0-9.]+) s", log)
    if not path or path.group(1) != "device" or not epochs:
        _fail("the shipped flags did not build the epoch on the device "
              "(the auto -device-epoch resolves on, as in the JAX package)")
    for name in ("fused_context_pallas", "scatter_add_span", "band_usum"):
        if launches[name] <= 0:
            _fail(f"{name} was not launched on the main path")
    if launches["row_parts"] != launches["scatter_add_span"]:
        _fail(f"kernel 2 read the rows from their parts in "
              f"{launches['row_parts']} of its {launches['scatter_add_span']} "
              "launches on the main path (all expected)")
    if launches["context_rows"] != launches["fused_context_pallas"]:
        _fail(f"kernel 1 read the rows from the table by id in "
              f"{launches['context_rows']} of its "
              f"{launches['fused_context_pallas']} launches on the main path "
              "(all expected)")
    if not all(math.isfinite(x) for x in losses):
        _fail(f"epoch loss not finite: {losses}")
    words, vecs = read_vectors(out)
    vocab_lines = re.search(r"Vocab size: (\d+)", log)
    V = int(vocab_lines.group(1))
    third = np.float32(1.0) / np.float32(3.0)
    if vecs.shape != (V, D) or len(words) != V:
        _fail(f"vector file holds {vecs.shape}, expected ({V}, {D})")
    if not np.all(np.abs(vecs) == third):
        _fail("bitlevel-1 vectors are not all +-1/3")
    print(f"[train] epochs built on the {path.group(1)} in "
          f"{float(epochs.group(1)):.2f} s")
    print(f"[train] {steps} steps, V={V}, epoch loss {losses[-1]:.4f}, "
          f"{float(m.group(3)):.1f} words/sec, {float(m.group(4)):.1f} "
          f"us/step; launches {launches}; vectors file {V} x {D} of +-1/3")
    return launches, out, corpus


# ------------------------------------------- [flagship]: capacity path
def _check_checkpoint(path: str, table: torch.Tensor) -> None:
    """Read state.npz's `u` and `v` members back in row blocks with numpy
    alone (uint16 bits of the bf16 halves, as the JAX _ckpt_encode stores
    them) and hold each block against the live fused table, bit for bit."""
    import zipfile
    D2 = table.shape[1] // 2
    step = 1 << 18
    with zipfile.ZipFile(path) as zf:
        for name, half in (("u", table[:, :D2]), ("v", table[:, D2:])):
            with zf.open(name + "_dtype.npy") as f:
                if str(np.lib.format.read_array(f)) != "bfloat16":
                    _fail(f"checkpoint {name} is not tagged bfloat16")
            with zf.open(name + ".npy") as f:
                np.lib.format.read_magic(f)
                shape, fortran, dt = np.lib.format.read_array_header_1_0(f)
                if (tuple(shape) != tuple(half.shape) or fortran
                        or dt != np.uint16):
                    _fail(f"checkpoint {name} is {shape} {dt}, not "
                          f"{tuple(half.shape)} uint16")
                for r0 in range(0, shape[0], step):
                    n = min(step, shape[0] - r0)
                    disk = np.frombuffer(f.read(n * D2 * 2), np.uint16)
                    live = half[r0:r0 + n].contiguous().view(
                        torch.int16).cpu().numpy().view(np.uint16)
                    if not np.array_equal(disk, live.reshape(-1)):
                        _fail(f"checkpoint {name} rows {r0}.. differ from "
                              "the trained table")


def train_flagship(work: str, dev) -> tuple:
    """The capacity configuration through train.train for FLAG_STEPS
    steps with -checkpoint-dir, its vectors and .pack written in row
    blocks (kernel 4 once per block, EXPORT_BLOCKS times), its checkpoint
    read back against the live table; returns the launch counts, the .pack
    path, the (vocab, encoded) corpus and the checkpoint directory."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.synthetic import zipf_vocab_corpus
    from word2bits_tpu_torch.io.packed import read_packed
    from word2bits_tpu_torch.ops.quantize import quantize

    # the runbook's flags; the output goes to the work directory, in the
    # binary format (its text format would format 2.96G values)
    out = os.path.join(work, "flagship.bin")
    ckdir = os.path.join(work, "ckpt")
    flags = list(FLAGSHIP_FLAGS)
    flags[flags.index("-output") + 1] = out
    cfg = config_from_argv(flags + ["-binary", "1", "-debug", "1",
                                    "-checkpoint-dir", ckdir])
    table_bytes = FLAG_V * 2 * FLAG_D * 2
    rss0 = _proc_status("VmRSS")
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        # V = 3,699,941 types, every count >= 5 (all survive -min-count 5)
        vocab, encoded = zipf_vocab_corpus(FLAG_V, head=FLAG_ZIPF_C,
                                           seed=SEED)
        print(f"[flagship] synthetic vocabulary V={vocab.size}, corpus of "
              f"{encoded.size} tokens ({vocab.train_words} train words) "
              f"built in {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        res = T.train(cfg, vocab=vocab, encoded=encoded,
                      max_steps=FLAG_STEPS, device=dev)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    rss_life = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if res.steps != FLAG_STEPS:
        _fail(f"flagship trained {res.steps} steps, not {FLAG_STEPS}")
    for name in ("fused_context_pallas", "context_rows", "scatter_add_grmw",
                 "row_parts", "band_usum"):
        if launches[name] != res.steps:
            _fail(f"flagship: {name} launched {launches[name]} times in "
                  f"{res.steps} steps (once per step expected)")
    if launches["quantize_pallas"] != EXPORT_BLOCKS:
        _fail(f"flagship: the export launched kernel 4 "
              f"{launches['quantize_pallas']} times, not {EXPORT_BLOCKS}")
    if not all(math.isfinite(x) for x in res.epoch_losses):
        _fail(f"flagship epoch loss not finite: {res.epoch_losses}")
    if peak > 1.25 * table_bytes:
        _fail(f"flagship peak device memory {peak} > 1.25 x the table's "
              f"{table_bytes} bytes")
    n2, words2, sec2 = res.chunks[1]
    sec = {k: round(v, 3) for k, v in res.seconds.items()}
    print(f"[flagship] V={vocab.size}, {res.steps} steps, epoch loss "
          f"{res.epoch_losses[-1]:.4f}; second chunk {sec2 / n2 * 1e6:.1f} "
          f"us/step, {words2 / sec2:.1f} words/sec; launches {launches}")
    print(f"[flagship] seconds: {sec}")
    print(f"[flagship] peak device memory {peak} bytes = "
          f"{peak / table_bytes:.4f} x the table ({table_bytes} bytes)")
    print(f"[flagship] peak host RSS from the data build to the end of "
          f"training and export {rss.peak} bytes = "
          f"{rss.peak / table_bytes:.4f} x the table (sampled every 20 ms; "
          f"{rss0} bytes at the phase's start); the process's peak host RSS "
          f"{rss_life} bytes = {rss_life / table_bytes:.4f} x the table")

    # the vector file: header + V rows of "word " + 4D bytes + "\n"
    want = len(f"{FLAG_V} {FLAG_D}\n") + sum(
        len(w.encode()) + 2 + 4 * FLAG_D for w in vocab.words)
    got = os.path.getsize(out)
    if got != want:
        _fail(f"flagship vector file holds {got} bytes, not {want}")
    os.remove(out)
    pack = out + ".pack"
    t0 = time.perf_counter()
    third = np.float32(1.0) / np.float32(3.0)
    n_rows, step = 0, 1 << 18
    for r0 in range(0, FLAG_V, step):
        words, vecs, bl = read_packed(pack, max_words=step, first_row=r0)
        blk = res.tables[0][r0:r0 + step]
        q = quantize(blk[:, :FLAG_D].float() + blk[:, FLAG_D:].float(),
                     1).cpu().numpy()
        if (bl != 1 or words != vocab.words[r0:r0 + step]
                or not np.all(np.abs(vecs) == third)
                or not np.array_equal(vecs, q)):
            _fail(f"flagship .pack rows {r0}.. do not read back as the "
                  "trained vectors (+-1/3)")
        n_rows += len(words)
    if n_rows != FLAG_V:
        _fail(f"flagship .pack holds {n_rows} rows, not {FLAG_V}")
    print(f"[flagship] vectors file {got} bytes; .pack {os.path.getsize(pack)}"
          f" bytes, export {res.seconds['export']:.1f} s ({EXPORT_BLOCKS} "
          f"blocks through kernel 4); read back as "
          f"{n_rows} x {FLAG_D} of +-1/3 equal to the trained table in "
          f"{time.perf_counter() - t0:.1f} s")
    # the same export with the plain quantize in kernel 4's place: the
    # export's seconds without the kernel, in this run
    from word2bits_tpu_torch.kernels.quantize_pallas import \
        quantize_pallas_plain
    fused = T.quantize_pallas
    T.quantize_pallas = lambda x, bl: quantize_pallas_plain(x, bl)
    t0 = time.perf_counter()
    try:
        T.write_output(out, vocab, res.tables, cfg)
    finally:
        T.quantize_pallas = fused
    plain_export = time.perf_counter() - t0
    if os.path.getsize(out) != want:
        _fail("flagship export with the plain quantize: wrong file size")
    os.remove(out)
    print(f"[flagship] the same export with the plain quantize in kernel "
          f"4's place: {plain_export:.1f} s (through kernel 4: "
          f"{res.seconds['export']:.1f} s)")
    ckpt = os.path.join(ckdir, "state.npz")
    t0 = time.perf_counter()
    _check_checkpoint(ckpt, res.tables[0])
    print(f"[flagship] checkpoint {os.path.getsize(ckpt)} bytes saved in "
          f"{res.seconds['checkpoint']:.1f} s; read back in row blocks "
          f"bit-equal to the trained table in "
          f"{time.perf_counter() - t0:.1f} s")
    return launches, pack, (vocab, encoded), ckdir


# ------------------------------- [flagship run]: the port's flagship tool
def flagship_run_shape() -> dict:
    """[flagship run]'s window, negatives and negative sharing, as the
    port's tool sets them at FLAGSHIP_RUN_ARGS (one negative pool)."""
    from word2bits_tpu_torch.config import Word2BitsConfig
    from word2bits_tpu_torch.tools import flagship_run as FR
    cfg = Word2BitsConfig(**FR.flagship_fields(
        FR.parse_args(FLAGSHIP_RUN_ARGS)))
    if (cfg.batch_size, cfg.size, cfg.neg_pool) != (FLAG_B, FLAG_D, 1):
        _fail(f"flagship run: the tool's B, D and pools ({cfg.batch_size}, "
              f"{cfg.size}, {cfg.neg_pool}) are not the ones checked")
    return dict(window=cfg.window, negative=cfg.negative,
                neg_sharing=cfg.neg_sharing)


def run_flagship_tool(work: str) -> dict:
    """The port's tools/flagship_run.py through its `run` entry point at
    FLAGSHIP_RUN_ARGS, everything under `work`: each leg launches kernels 1
    and 7 once per step, kernel 4 runs the export's EXPORT_BLOCKS blocks in
    leg 2 and never in leg 1, leg 2 starts at epoch 1 and trains one
    epoch, every epoch loss is finite, leg 2 goes on from leg 1's table
    (its first chunk's loss a step above leg 1's first, taken at the
    init, and its epoch's loss above leg 1's), each leg's peak device
    memory is at most 1.25 x the table, the vectors read back as +-1/3
    and the evaluation covers every question over every row.  The run directory
    (checkpoint, vector files, corpus) is removed once checked.  Returns
    the phase's launch counts."""
    from word2bits_tpu_torch.tools import flagship_run as FR
    run_dir = os.path.join(work, "flagship_run")
    _zero_launches()
    t = FR.run(FLAGSHIP_RUN_ARGS + ["--run-dir", run_dir, "--transcript",
                                    os.path.join(run_dir, "transcript.md")])
    launches = _read_launches()
    tr, rs, ev = t["train"], t["resume"], t["eval"]
    for leg, rec in (("leg 1", tr), ("leg 2", rs)):
        for name in ("fused_context_pallas", "context_rows",
                     "scatter_add_grmw", "row_parts", "band_usum"):
            if rec["launches"][name] != rec["steps"]:
                _fail(f"flagship run {leg}: {name} launched "
                      f"{rec['launches'][name]} times in {rec['steps']} "
                      "steps (once per step expected)")
        if not all(math.isfinite(x) for x in rec["epoch_losses"]):
            _fail(f"flagship run {leg}: epoch loss not finite: "
                  f"{rec['epoch_losses']}")
        if rec["peak_device_x_table"] > 1.25:
            _fail(f"flagship run {leg}: peak device memory "
                  f"{rec['peak_device_bytes']} bytes = "
                  f"{rec['peak_device_x_table']} x the table (> 1.25)")
    if (tr["launches"]["quantize_pallas"] != 0
            or rs["launches"]["quantize_pallas"] != EXPORT_BLOCKS):
        _fail(f"flagship run: kernel 4 launched "
              f"{tr['launches']['quantize_pallas']} times in leg 1 and "
              f"{rs['launches']['quantize_pallas']} in leg 2 (0 and "
              f"{EXPORT_BLOCKS} expected)")
    if rs["start_epoch"] != 1 or len(rs["epoch_losses"]) != 1:
        _fail(f"flagship run: leg 2 started at epoch {rs['start_epoch']} "
              f"and trained {len(rs['epoch_losses'])} epochs (1 and 1 "
              "expected)")
    if not (rs["first_chunk_loss_per_step"] > tr["first_chunk_loss_per_step"]
            and rs["epoch_losses"][0] > tr["epoch_losses"][-1]):
        _fail(f"flagship run: leg 2 did not go on from leg 1's table: "
              f"first chunk's loss a step {rs['first_chunk_loss_per_step']} "
              f"(leg 1 {tr['first_chunk_loss_per_step']}), epoch loss "
              f"{rs['epoch_losses']} (leg 1 {tr['epoch_losses']})")
    for name in ("fused_context_pallas", "scatter_add_grmw", "band_usum",
                 "quantize_pallas"):
        if launches[name] != tr["launches"][name] + rs["launches"][name]:
            _fail(f"flagship run: {name} launched {launches[name]} times, "
                  "not the legs' sum")
    if (not ev["values_pm_one_third"] or ev["coverage"] != 100.0
            or ev["rows"] != t["corpus"]["vocab_size"]
            or t["corpus"]["vocab_size"] != FLAG_V):
        _fail(f"flagship run: evaluation {ev} over a vocabulary of "
              f"{t['corpus']['vocab_size']} (100% coverage over all "
              f"{FLAG_V} rows of +-1/3 expected)")
    c = t["corpus"]
    print(f"[flagship run] {t['device']['card']}: corpus of "
          f"{c['encoded_tokens']} tokens, V={c['vocab_size']}, "
          f"{t['config']['segments_per_epoch']} segments an epoch; corpus "
          f"built in {c['build_s']} s, parse and vocabulary "
          f"{c['parse_vocab_s']} s")
    for leg, rec in (("leg 1", tr), ("leg 2", rs)):
        print(f"[flagship run] {leg}: epochs from {rec['start_epoch']}, "
              f"{rec['steps']} steps, losses {rec['epoch_losses']} "
              f"(a step: {rec['first_chunk_loss_per_step']} in the first "
              f"chunk, {rec['last_chunk_loss_per_step']} in the last), "
              f"{rec['loop_words_per_sec']} words/sec on the card's clock "
              f"({rec['loop_s']} s in chunks), wall {rec['wall_s']} s; "
              f"seconds {rec['seconds']}; peak device memory "
              f"{rec['peak_device_bytes']} bytes = "
              f"{rec['peak_device_x_table']} x the table, peak host RSS "
              f"{rec['peak_host_rss_bytes']}; launches {rec['launches']}")
    print(f"[flagship run] artifacts {t['artifacts']}; vectors read back in "
          f"{ev['read_s']} s as +-1/3; evaluation over {ev['rows']} rows "
          f"in {ev['eval_s']} s: total accuracy {ev['total_accuracy']}%, "
          f"coverage {ev['coverage']}% of {ev['total_questions']} "
          f"questions, peak device memory {ev['peak_device_bytes']} bytes; "
          f"cross-check {t['crosscheck']}; peak host RSS "
          f"{t['peak_host_rss_bytes']} bytes")
    shutil.rmtree(run_dir)
    return launches


# ---------------------------------------- [resume]: checkpoint at capacity
def run_resume(dev, vocab, encoded, ckdir: str) -> dict:
    """[flagship]'s checkpoint (epoch 0, cut by max_steps) resumed with
    -resume 1 through train.train for RESUME_STEPS steps of epoch 1, no
    -output: the tables are allocated once and filled in row blocks (no
    initialization first), the generator state and words_done restored;
    peak device memory <= 1.25 x the table, the host's RSS beside it.  The
    run saves its own checkpoint at its end, as the JAX package's does."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    flags = FLAGSHIP_FLAGS[2:] + ["-debug", "1", "-checkpoint-dir", ckdir,
                                  "-resume", "1"]
    cfg = config_from_argv(flags)
    state = os.path.join(ckdir, "state.npz")
    with np.load(state) as z:
        saved_words = float(z["words_done"])
        saved_epoch = int(z["epoch"])
    table_bytes = FLAG_V * 2 * FLAG_D * 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss0 = _proc_status("VmRSS")
    _zero_launches()
    with _RssPeak() as rss:
        res = T.train(cfg, vocab=vocab, encoded=encoded,
                      max_steps=RESUME_STEPS, device=dev)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    if saved_epoch != 0 or res.start_epoch != 1 or "load" not in res.seconds:
        _fail(f"resume: checkpoint of epoch {saved_epoch}, run started at "
              f"epoch {res.start_epoch}, seconds {res.seconds}")
    if res.steps != RESUME_STEPS or len(res.epoch_losses) != 1:
        _fail(f"resume trained {res.steps} steps over "
              f"{len(res.epoch_losses)} epochs")
    if not (saved_words < res.words_done
            < saved_words + vocab.train_words):
        _fail(f"resume: words_done {res.words_done} does not continue the "
              f"checkpoint's {saved_words}")
    if not all(math.isfinite(x) for x in res.epoch_losses):
        _fail(f"resume epoch loss not finite: {res.epoch_losses}")
    for name in ("fused_context_pallas", "context_rows", "scatter_add_grmw",
                 "row_parts", "band_usum"):
        if launches[name] != res.steps:
            _fail(f"resume: {name} launched {launches[name]} times in "
                  f"{res.steps} steps")
    if peak > 1.25 * table_bytes:
        _fail(f"resume peak device memory {peak} > 1.25 x the table's "
              f"{table_bytes} bytes")
    us, wps = _steady(res)
    print(f"[resume] from epoch {saved_epoch} ({saved_words:.0f} words) to "
          f"epoch {res.start_epoch}: {res.steps} steps, loss "
          f"{res.epoch_losses[-1]:.4f}, {us:.1f} us/step, words_done "
          f"{res.words_done:.0f}; load {res.seconds['load']:.1f} s, its own "
          f"checkpoint saved in {res.seconds['checkpoint']:.1f} s; peak "
          f"device memory {peak} bytes = {peak / table_bytes:.4f} x the "
          f"table; peak host RSS {rss.peak} bytes = "
          f"{rss.peak / table_bytes:.4f} x the table ({rss0} bytes at the "
          f"start); launches {launches}")
    del res
    torch.cuda.empty_cache()
    return launches


# ------------------------------- [rmw]: the earlier capacity path
def run_rmw(dev, vocab, encoded) -> dict:
    """The capacity configuration with -rmw-scatter 1 -steps-per-chunk 1
    through train.train for RMW_STEPS steps on [flagship]'s corpus:
    kernel 8 twice a step (the slab rows, then the negative rows) and the
    context kernel once; peak device memory <= 1.25 x the table."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    cfg = config_from_argv(RMW_FLAGS + ["-debug", "1"])
    table_bytes = FLAG_V * 2 * FLAG_D * 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    res = T.train(cfg, vocab=vocab, encoded=encoded, max_steps=RMW_STEPS,
                  device=dev)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    if res.steps != RMW_STEPS:
        _fail(f"rmw trained {res.steps} steps, not {RMW_STEPS}")
    if (launches["scatter_add_rmw"] != 2 * res.steps
            or launches["fused_context_pallas"] != res.steps
            or launches["band_usum"] != res.steps):
        _fail(f"rmw: launches {launches} in {res.steps} steps (kernel 8 "
              "twice, kernel 1 and the banded u-sum once per step "
              "expected)")
    if not all(math.isfinite(x) for x in res.epoch_losses):
        _fail(f"rmw epoch loss not finite: {res.epoch_losses}")
    if peak > 1.25 * table_bytes:
        _fail(f"rmw peak device memory {peak} > 1.25 x the table's "
              f"{table_bytes} bytes")
    us, wps = _steady(res)
    print(f"[rmw] V={vocab.size}, {res.steps} steps of B={cfg.batch_size}, "
          f"loss {res.epoch_losses[-1]:.4f}; steady {us:.1f} us/step, "
          f"{wps:.1f} words/sec (one-step chunks after the first); peak "
          f"device memory {peak} bytes = {peak / table_bytes:.4f} x the "
          f"table; launches {launches}")
    del res
    torch.cuda.empty_cache()
    return launches


# ------------------------------------- [quickstart]: reference default
def _launch_counters():
    """Every ported kernel's wrapper, by the name in the kernels line."""
    from word2bits_tpu_torch.kernels.band_usum import band_usum
    from word2bits_tpu_torch.kernels.context_pallas import (
        fused_context_pallas, fused_context_rows)
    from word2bits_tpu_torch.kernels.group_rmw import \
        scatter_add_grmw_planned
    from word2bits_tpu_torch.kernels.hot_pallas import hot_slice_add_pallas
    from word2bits_tpu_torch.kernels.quantize_pallas import quantize_pallas
    from word2bits_tpu_torch.kernels.scatter_pallas import scatter_add_rmw
    from word2bits_tpu_torch.kernels.score_pallas import \
        quantized_scores_pallas
    from word2bits_tpu_torch.kernels.span_scatter import (
        launch_parts, scatter_add_span_planned, scatter_add_span_rank1)
    from word2bits_tpu_torch.kernels.pos_context import pos_context
    from word2bits_tpu_torch.kernels.subword_mean import subword_mean
    from word2bits_tpu_torch.kernels.sweep_scatter import \
        scatter_add_sweep_planned
    # row_parts: the launches of kernels 2 and 7 that read the fused step's
    # rows from their three parts; context_rows: kernel 1's that read the
    # rows from the table by id (both counted in their own entries too)
    return {"fused_context_pallas": fused_context_pallas,
            "context_rows": fused_context_rows,
            "scatter_add_span": scatter_add_span_planned,
            "scatter_add_span_rank1": scatter_add_span_rank1,
            "row_parts": launch_parts,
            "quantized_scores_pallas": quantized_scores_pallas,
            "hot_slice_add_pallas": hot_slice_add_pallas,
            "scatter_add_grmw": scatter_add_grmw_planned,
            "scatter_add_rmw": scatter_add_rmw,
            "quantize_pallas": quantize_pallas,
            "scatter_add_sweep": scatter_add_sweep_planned,
            "band_usum": band_usum,
            "subword_mean": subword_mean,
            "pos_context": pos_context}


def _zero_launches() -> None:
    for fn in _launch_counters().values():
        fn.launches = 0


def _read_launches() -> dict:
    return {n: fn.launches for n, fn in _launch_counters().items()}


def _steady(res) -> tuple:
    """(us/step, words/sec) over the chunks after the first (all of them
    when there is one), on the card's clock."""
    chunks = res.chunks[1:] or res.chunks
    n = sum(c[0] for c in chunks)
    words = sum(c[1] for c in chunks)
    sec = sum(c[2] for c in chunks)
    return sec / n * 1e6, words / sec


def train_quickstart(work: str, corpus: str, dev) -> tuple:
    """The README Quick start's flags through the CLI's config_from_argv
    and train.train, cut to QS_STEPS steps; returns the launch counts and
    the prepared (vocab, encoded) corpus for the later phases."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.io.vectors import read_vectors
    out = os.path.join(work, "quickstart.bin")
    cfg = config_from_argv(["-train", corpus, "-output", out]
                           + QUICKSTART_FLAGS + ["-debug", "1"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        vocab, encoded = T.prepare(cfg)
    print(f"[quickstart] vocabulary of {vocab.size} words and "
          f"{encoded.size} tokens read in {time.perf_counter() - t0:.1f} s")
    _zero_launches()
    res = T.train(cfg, vocab=vocab, encoded=encoded, max_steps=QS_STEPS,
                  device=dev)
    launches = _read_launches()
    if res.steps != QS_STEPS or len(res.tables) != 2:
        _fail(f"quickstart trained {res.steps} steps on {len(res.tables)} "
              f"tables, not {QS_STEPS} on split tables")
    if not all(math.isfinite(x) for x in res.epoch_losses):
        _fail(f"quickstart epoch loss not finite: {res.epoch_losses}")
    words, vecs = read_vectors(out)
    third = np.float32(1.0) / np.float32(3.0)
    if (vecs.shape != (vocab.size, D) or words != vocab.words
            or not np.all(np.abs(vecs) == third)):
        _fail(f"quickstart vectors file holds {vecs.shape}, not "
              f"({vocab.size}, {D}) rows of +-1/3")
    us, wps = _steady(res)
    print(f"[quickstart] {res.steps} steps of B={cfg.batch_size} (the run "
          f"is cut at {QS_STEPS} steps; one epoch of {encoded.size} tokens "
          f"before subsampling is at most "
          f"{math.ceil(encoded.size / cfg.batch_size)} steps), loss "
          f"{res.epoch_losses[-1]:.4f}; steady {us:.1f} us/step, "
          f"{wps:.1f} words/sec (chunks after the first; whole loop "
          f"{res.words_per_sec:.1f} words/sec); launches {launches}; "
          f"vectors file {vocab.size} x {D} of +-1/3")
    return launches, (vocab, encoded)


# ------------------------------- [determinism]: same seed, same vectors
# (b)'s routes at full width, (tag, flags, steps): each runs twice through
# train.build_engine's chunk from the same generator seed (bit-equal
# tables, equal losses) and once from another seed (different tables)
DET_ROUTES = (
    ("quickstart", QUICKSTART_FLAGS, 256),
    ("pallas", PALLAS_FLAGS, S),
    ("hot, no kernel 6", ADD_FLAGS + ["-hot-rows", str(HOT)], S),
    ("stratified", ADD_FLAGS + ["-hot-rows", str(HOT), "-neg-stratify", "1"],
     S),
    ("dense-hot", ADD_FLAGS + ["-hot-rows", str(HOT), "-neg-dense-hot", "1"],
     S),
    ("skipgram", QUICKSTART_FLAGS + SG_FLAGS, 256),
    ("dedup fused", ADD_FLAGS + ["-dedup-block", "1024"], S),
    ("dedup split", QUICKSTART_FLAGS + ["-dedup-block", "1024"], 256),
)
DET_MESH_STEPS = 64              # the 2 x 2 LocalMesh on the `add` route
DET_E2E_STEPS = 256              # (c): the Quick start through train.train


def _sum_launches(total: dict, launches: dict) -> dict:
    for n, c in launches.items():
        total[n] = total.get(n, 0) + c
    return total


def _det_audit(dev) -> list:
    """(a) One step of each _step_cases configuration, of skip-gram
    (per-center and dense-hot) and of the 2 x 2 LocalMesh `add` body on
    the card under utils/audit.ScatterAudit: the accumulating scatters
    called on CUDA tensors, by route.  Returns the faults."""
    from word2bits_tpu_torch.models import cbow_slab as cs
    from word2bits_tpu_torch.models import skipgram as sg
    from word2bits_tpu_torch.models.cbow import CBOWHyper
    from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
    from word2bits_tpu_torch.parallel.mesh import LocalMesh
    from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body
    from word2bits_tpu_torch.parallel.sharded_skipgram import \
        _sharded_skipgram_body
    from word2bits_tpu_torch.sampling.unigram import build_alias_table
    from word2bits_tpu_torch.utils.audit import ScatterAudit
    data, cases = _step_cases()
    seen = {}
    for case in cases:
        with ScatterAudit() as audit:
            _run_step_case(data, case, dev, what=("step",))
        torch.cuda.synchronize()
        seen[case[0]] = audit.on_cuda()
    b, w, v = data["b"], data["w"], data["v"]
    hyper = data["hyper"]
    toks, sents = data["tokens"].to(dev), data["sents"].to(dev)
    dense = data["dense"]
    for name, dh in (("skipgram", False), ("skipgram dense-hot", True)):
        negs = (cases[3][6] if not dh else torch.from_numpy(
            np.random.default_rng(SEED + 2).integers(32, v, (3, b,
                                                         dense[0]))))
        st_in = cs.SlabInputs(toks[:b + 2 * w], sents[:b + 2 * w],
                              data["shrinks"][0].to(dev), negs[0].to(dev))
        step_dense = ((dense[1], torch.from_numpy(dense[2]).to(dev))
                      if dh else None)
        with ScatterAudit() as audit:
            sg.skipgram_slab_step(
                data["u0"].to(dev), data["v0"].to(dev), st_in,
                torch.tensor(0.05, device=dev),
                CBOWHyper(bitlevel=1, size=hyper.size, window=w,
                          negative=negs.shape[-1]), b,
                dense_hot=step_dense)
        torch.cuda.synchronize()
        seen[name] = audit.on_cuda()
    atab = build_alias_table(np.ones(v)).to(dev)
    g = 8
    negs = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        1, v, (1, b // g, 2 * hyper.negative))).to(dev)
    for name, body, kw in (
            ("mesh 2x2 add", _sharded_slab_body,
             dict(neg_sharing=g, neg_pool=2, banded=8, scatter_impl="add")),
            ("mesh 2x2 skipgram", _sharded_skipgram_body,
             dict(neg_sharing=g, neg_pool=2))):
        chunk = make_sharded_chunk(body, hyper, LocalMesh(2, 2), v, v, b, 1,
                                   **kw)
        audits = []

        def shard(comm):
            ul = data["u0"][comm.rank % 2 * (v // 2):][:v // 2].to(dev)
            vl = data["v0"][comm.rank % 2 * (v // 2):][:v // 2].to(dev)
            with ScatterAudit() as audit:
                audits.append(audit)
                chunk(comm, ul, vl, toks, sents, atab, data["sc"],
                      shrinks=data["shrinks"][:1].to(dev), negs=negs)
            return None

        LocalMesh(2, 2, dev).run(shard)
        torch.cuda.synchronize()
        seen[name] = [c for a in audits for c in a.on_cuda()]
    faults = []
    for name, calls in seen.items():
        ops = sorted({f"{c.op} from {c.caller}" for c in calls})
        print(f"[determinism] (a) {name}: "
              f"{len(calls)} accumulating scatters on the card"
              + (f": {'; '.join(ops)}" if ops else ""))
        if calls:
            faults.append(f"(a) {name}: {len(calls)} accumulating scatters "
                          f"on the card ({'; '.join(ops)})")
    return faults


def _det_step_chunks(dev) -> list:
    """(b) Each _step_cases configuration's 3-step chunk twice on the card
    from the same tables and draws: the tables' digests and the losses
    must be equal.  Returns the faults."""
    data, cases = _step_cases()
    faults = []
    for case in cases:
        runs = []
        for _ in range(2):
            tabs, loss = _run_step_case(data, case, dev, what=("chunk",))[
                "chunk"]
            runs.append(([_digest(t) for t in tabs], float(loss)))
        same = runs[0] == runs[1]
        print(f"[determinism] (b) {case[0]} 3-step chunk twice: digests "
              f"{runs[0][0]} / {runs[1][0]}, losses {runs[0][1]!r} / "
              f"{runs[1][1]!r}: {'equal' if same else 'DIFFERENT'}")
        if not same:
            faults.append(f"(b) {case[0]}: two chunks from one state differ")
    return faults


def _det_epoch(cfg, vocab, encoded, dev, cache: dict):
    """The host-built epoch of cfg's capacity (cached): (tokens, sents on
    dev, host tokens, capacity)."""
    from word2bits_tpu_torch.data.pipeline import build_epoch_arrays
    from word2bits_tpu_torch.train import segment_capacity
    cap = segment_capacity(cfg, len(encoded))[1]
    if (cap, cfg.window) not in cache:
        ea = build_epoch_arrays(encoded, vocab.counts, cfg.sample,
                                vocab.train_words, cfg.window,
                                np.random.default_rng(SEED), capacity=cap)
        cache[(cap, cfg.window)] = (
            torch.from_numpy(ea.tokens).to(dev, torch.int64),
            torch.from_numpy(ea.sent_ids).to(dev, torch.int64),
            ea.tokens, cap)
    return cache[(cap, cfg.window)]


def _engine_run(cfg, vocab, epoch, cold, dev, steps: int, seed: int):
    """`steps` steps of train.build_engine's chunk for cfg from its init,
    the generator seeded `seed`: (tables, chunk losses, launches)."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    B_, S_ = cfg.batch_size, cfg.steps_per_chunk
    hyper = CBOWHyper(bitlevel=cfg.bitlevel, size=cfg.size,
                      window=cfg.window, negative=cfg.negative, reg=cfg.reg)
    engine = T.build_engine(cfg, vocab, T.init_tables(cfg, vocab.size, dev),
                            hyper)
    tokens, sents = epoch[:2]
    kw = {"cold_pos": cold} if engine.cold_split else {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    tabs, losses = list(engine.tables), []
    denom = cfg.iter * float(vocab.train_words) + 1.0
    _zero_launches()
    for c in range(0, steps, S_):
        sc = ChunkScalars(base0=cfg.window + c * B_,
                          alpha0=cfg.effective_alpha,
                          wca_start=float(c * B_), wca_per_step=float(B_),
                          denom=denom)
        *tabs, loss = engine.chunk_fn(*tabs, tokens, sents, engine.alias,
                                      sc, gen, n_steps=min(S_, steps - c),
                                      **kw)
        losses.append(float(loss))
    return tabs, losses, _read_launches()


def _det_routes(dev, vocab, encoded) -> tuple:
    """(b) DET_ROUTES and the 2 x 2 LocalMesh `add` route at full width:
    seed SEED twice (bit-equal tables, equal losses), SEED + 1 once
    (different tables).  Returns (faults, launches of the runs by
    path)."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.models.init import init_params
    from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                      draw_negatives)
    faults, by_path, epochs = [], {}, {}

    def judge(tag, runs, what):
        (d1, l1), (d2, l2), (d3, _) = runs
        same, other = (d1 == d2 and l1 == l2), d3 != d1
        print(f"[determinism] (b) {tag}, {what}: seed {SEED} twice "
              f"{d1} / {d2}, losses {l1} / {l2}: "
              f"{'equal' if same else 'DIFFERENT'}; seed {SEED + 1} {d3}: "
              f"{'different' if other else 'THE SAME'}")
        if not same:
            faults.append(f"(b) {tag}: two runs from seed {SEED} differ")
        if not other:
            faults.append(f"(b) {tag}: seed {SEED + 1} gave seed {SEED}'s "
                          "tables")

    for tag, flags, steps in DET_ROUTES:
        cfg = config_from_argv(flags)
        epoch = _det_epoch(cfg, vocab, encoded, dev, epochs)
        cold = None
        if cfg.fused_on and cfg.hot_rows and not cfg.device_epoch_on:
            cold = torch.from_numpy(T.cold_map(cfg, epoch[2], epoch[3])).to(
                dev, torch.int64)
        runs, t0 = [], time.perf_counter()
        for seed in (SEED, SEED, SEED + 1):
            tabs, losses, launches = _engine_run(cfg, vocab, epoch, cold,
                                                 dev, steps, seed)
            runs.append(([_digest(t) for t in tabs], losses))
            if seed == SEED:
                _sum_launches(by_path.setdefault(tag, {}), launches)
            del tabs
        judge(tag, runs, f"{steps} steps of B={cfg.batch_size}, "
              f"{cfg.dtype}, {time.perf_counter() - t0:.1f} s for 3 runs")
    # the 2 x 2 LocalMesh on the `add` route (split bf16 tables, the
    # shipped widths), its draws from the generator of each seed
    V, n = vocab.size, DET_MESH_STEPS
    tokens, sents = _epoch(vocab, encoded, dev, B, S, W)
    atab = build_alias_table(vocab.unigram_weights()).to(dev)
    scalars = ChunkScalars(base0=W, alpha0=0.1, wca_start=0.0,
                           wca_per_step=float(B),
                           denom=float(vocab.train_words) + 1.0)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    kw = dict(neg_sharing=G, neg_pool=P, banded=TILE, scatter_impl="add")
    runs, t0 = [], time.perf_counter()
    for seed in (SEED, SEED, SEED + 1):
        gen = torch.Generator(device=dev).manual_seed(seed)
        shrinks = torch.randint(0, W, (n, B), generator=gen, device=dev)
        negs = draw_negatives(gen, atab, (n, B // G, P * K), V)
        u0, v0 = init_params(V, D, dtype=torch.bfloat16, device=dev)
        mu, mv, loss, launches, _ = _local_mesh_chunk(
            dev, 2, 2, u0, v0, n, kw, hyper, V, B,
            (tokens, sents, atab, scalars, shrinks, negs), n)
        runs.append(([_digest(mu), _digest(mv)], [loss]))
        if seed == SEED:
            _sum_launches(by_path.setdefault("mesh 2x2 add", {}), launches)
        del mu, mv, u0, v0
    judge("mesh 2x2 add", runs, f"{n} bf16 steps of B={B}, "
          f"{time.perf_counter() - t0:.1f} s for 3 runs")
    torch.cuda.empty_cache()
    return faults, by_path


def _det_end_to_end(work: str, dev, vocab, encoded) -> tuple:
    """(c) The Quick start through train.train at -seed 1 twice and -seed
    2 once, cut at DET_E2E_STEPS steps: the two -seed 1 vector files must
    be byte-equal, the -seed 2 file different.  Returns (faults,
    launches of the -seed 1 runs)."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    digests, launches = [], {}
    for i, seed in enumerate((1, 1, 2)):
        out = os.path.join(work, f"determinism{i}.bin")
        cfg = config_from_argv(QUICKSTART_FLAGS + ["-seed", str(seed),
                                                   "-output", out])
        _zero_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            T.train(cfg, vocab=vocab, encoded=encoded,
                    max_steps=DET_E2E_STEPS, device=dev)
        if seed == 1:
            _sum_launches(launches, _read_launches())
        with open(out, "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest()[:16])
        os.remove(out)
    same, other = digests[0] == digests[1], digests[2] != digests[0]
    print(f"[determinism] (c) the Quick start through train.train, "
          f"{DET_E2E_STEPS} steps: -seed 1 twice {digests[0]} / "
          f"{digests[1]}: {'byte-equal' if same else 'DIFFERENT'}; -seed 2 "
          f"{digests[2]}: {'different' if other else 'THE SAME'}")
    faults = []
    if not same:
        faults.append("(c) two -seed 1 vector files differ")
    if not other:
        faults.append("(c) -seed 2 wrote -seed 1's vector file")
    return faults, launches


def check_determinism(work: str, dev, vocab, encoded) -> dict:
    """[determinism]: (a) the audit, (b) every route twice from one seed
    (and its chunk twice from one state), (c) the Quick start's vector
    files twice from -seed 1.  Fails on any fault, after all three parts
    ran; returns the launches of (b)'s and (c)'s runs by path."""
    t0 = time.perf_counter()
    faults = _det_audit(dev) + _det_step_chunks(dev)
    more, by_path = _det_routes(dev, vocab, encoded)
    faults += more
    more, by_path["quickstart e2e"] = _det_end_to_end(work, dev, vocab,
                                                       encoded)
    faults += more
    print(f"[determinism] {time.perf_counter() - t0:.1f} s; "
          f"{len(faults)} faults ({_card_line()})")
    if faults:
        _fail("determinism: " + "; ".join(faults))
    return {f"determinism {tag}": c for tag, c in by_path.items()}


# ------------------------------------------ [exact]: rank-1 A/B on card
def run_exact(dev, vocab, encoded) -> tuple:
    """One EXACT_S-step chunk of make_slab_train_chunk with materialized
    negative rows and one with the rank-1 span scatter, from the same state
    and the same injected draws, twice in turns (materialized, rank-1,
    materialized, rank-1; the second pair is timed); the two tables must
    agree (atol 1e-5: the rows are the same float32 products summed in the
    same order)."""
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.pipeline import build_epoch_arrays
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.models.cbow_slab import make_slab_train_chunk
    from word2bits_tpu_torch.models.init import init_params
    from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                      draw_negatives)
    from word2bits_tpu_torch.train import segment_capacity
    cfg = config_from_argv(EXACT_FLAGS)
    Bx, Sx = cfg.batch_size, cfg.steps_per_chunk
    hyper = CBOWHyper(bitlevel=cfg.bitlevel, size=D, window=W, negative=K)
    ea = build_epoch_arrays(encoded, vocab.counts, cfg.sample,
                            vocab.train_words, W, np.random.default_rng(SEED),
                            capacity=segment_capacity(cfg, len(encoded))[1])
    tokens = torch.from_numpy(ea.tokens).to(dev, torch.int64)
    sents = torch.from_numpy(ea.sent_ids).to(dev, torch.int64)
    atab = build_alias_table(vocab.unigram_weights()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shrinks = torch.randint(0, W, (Sx, Bx), generator=gen, device=dev)
    negs = draw_negatives(gen, atab, (Sx, Bx, K), vocab.size)
    u0, v0 = init_params(vocab.size, D, device=dev)
    sc = ChunkScalars(base0=W, alpha0=cfg.effective_alpha, wca_start=0.0,
                      wca_per_step=float(Bx),
                      denom=cfg.iter * float(vocab.train_words) + 1.0)
    out, times = {}, {}
    launches = {}
    for rank1 in (False, True, False, True):
        chunk = make_slab_train_chunk(
            hyper, vocab.size, Bx, Sx, banded=cfg.banded_tile,
            scatter_impl=cfg.scatter_impl, context_pallas=cfg.context_pallas,
            span_rank1=rank1)
        u, v = u0.clone(), v0.clone()
        torch.cuda.synchronize()
        _zero_launches()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        u, v, loss = chunk(u, v, tokens, sents, atab, sc, shrinks=shrinks,
                           negs=negs)
        stop.record()
        torch.cuda.synchronize()
        tag = "rank-1" if rank1 else "materialized"
        times[tag] = start.elapsed_time(stop) * 1e3 / Sx
        out[tag] = (u, v, float(loss))
        if rank1:
            launches = _read_launches()
    (um, vm, lm), (ur, vr, lr) = out["materialized"], out["rank-1"]
    err = max(_max_err(um, ur), _max_err(vm, vr))
    if not (torch.allclose(um, ur, atol=1e-5) and torch.allclose(vm, vr,
                                                                atol=1e-5)):
        _fail(f"exact: rank-1 and materialized tables differ by {err:.3e}")
    if not (math.isfinite(lr) and abs(lr - lm) <= 1e-5 * abs(lm)):
        _fail(f"exact: rank-1 loss {lr} vs materialized {lm}")
    if launches["scatter_add_span_rank1"] != Sx:
        _fail(f"exact: the rank-1 kernel launched "
              f"{launches['scatter_add_span_rank1']} times in {Sx} steps")
    print(f"[exact] B={Bx}, {Sx} steps per chunk, V={vocab.size}: "
          f"materialized {times['materialized']:.1f} us/step, rank-1 "
          f"{times['rank-1']:.1f} us/step (second of two turns each); "
          f"tables agree to {err:.3e}, losses {lm:.6f}/{lr:.6f}; rank-1 "
          f"chunk launches {launches}")
    return launches, times


# ---------------------------------------- [pallas]: score kernel paths
def run_pallas(dev, vocab, encoded) -> dict:
    """The shipped flags with -scatter-impl add -use-pallas 1, one
    S-step chunk through train.train with -fused-tables 1 and with
    -fused-tables 0; the score and context kernels launch once per step."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    by_path = {}
    for fused in ("1", "0"):
        flags = list(PALLAS_FLAGS)
        flags[flags.index("-fused-tables") + 1] = fused
        cfg = config_from_argv(flags)
        _zero_launches()
        res = T.train(cfg, vocab=vocab, encoded=encoded, max_steps=S,
                      device=dev)
        launches = _read_launches()
        tag = "pallas_fused" if fused == "1" else "pallas_split"
        for name in ("quantized_scores_pallas", "fused_context_pallas"):
            if launches[name] != res.steps or res.steps != S:
                _fail(f"{tag}: {name} launched {launches[name]} times in "
                      f"{res.steps} steps (once per step of {S} expected)")
        if launches["row_parts"]:
            _fail(f"{tag}: the `add` route read rows from their parts "
                  f"{launches['row_parts']} times (never expected)")
        if not all(math.isfinite(x) for x in res.epoch_losses):
            _fail(f"{tag} epoch loss not finite: {res.epoch_losses}")
        us, wps = _steady(res)
        print(f"[pallas] -fused-tables {fused}: {res.steps} steps of "
              f"B={cfg.batch_size}, "
              f"loss {res.epoch_losses[-1]:.4f}, {us:.1f} us/step, "
              f"{wps:.1f} words/sec (one chunk, its warm-up included); "
              f"launches {launches}")
        by_path[tag] = launches
        del res
    return by_path


# ------------------------------------------ [hot]: the hot/cold split
def run_hot(work: str, dev, vocab, encoded) -> dict:
    """HOT_FLAGS through train.train on [train]'s corpus, HOT_STEPS steps,
    its vectors read back; then one S-step chunk each with -neg-stratify
    1, with -neg-dense-hot 1 -device-epoch 0, and with -neg-dense-hot 1
    under the auto -device-epoch, whose step has no cold map and launches
    kernel 6 no time (as in the JAX package)."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.io.vectors import read_vectors
    out = os.path.join(work, "hot.bin")
    runs = (("hot", ["-output", out], HOT_STEPS, 1),
            ("hot_stratify", ["-neg-stratify", "1"], S, 1),
            ("hot_dense", ["-neg-dense-hot", "1", "-device-epoch", "0"], S,
             1),
            ("hot_dense_auto", ["-neg-dense-hot", "1"], S, 0))
    by_path = {}
    for tag, extra, steps, per_step in runs:
        cfg = config_from_argv(HOT_FLAGS + extra)
        _zero_launches()
        res = T.train(cfg, vocab=vocab, encoded=encoded, max_steps=steps,
                      device=dev)
        launches = _read_launches()
        if res.steps != steps:
            _fail(f"{tag} trained {res.steps} steps, not {steps}")
        if (launches["hot_slice_add_pallas"] != per_step * steps
                or launches["fused_context_pallas"] != steps
                or launches["row_parts"]):
            _fail(f"{tag}: launches {launches} in {steps} steps (kernel 6 "
                  f"{per_step} and kernel 1 once per step, no read of row "
                  "parts expected)")
        if not all(math.isfinite(x) for x in res.epoch_losses):
            _fail(f"{tag} epoch loss not finite: {res.epoch_losses}")
        us, wps = _steady(res)
        print(f"[hot] {' '.join(extra) or 'the hot flags'}: {res.steps} "
              f"steps of B={cfg.batch_size}, H={cfg.hot_rows}, loss "
              f"{res.epoch_losses[-1]:.4f}, {us:.1f} us/step, {wps:.1f} "
              f"words/sec (chunks after the first, or the one chunk); cold "
              f"maps {res.seconds['cold_map']:.2f} s; launches {launches}")
        by_path[tag] = launches
        del res
    words, vecs = read_vectors(out)
    third = np.float32(1.0) / np.float32(3.0)
    if (vecs.shape != (vocab.size, D) or words != vocab.words
            or not np.all(np.abs(vecs) == third)):
        _fail(f"hot vectors file holds {vecs.shape}, not ({vocab.size}, "
              f"{D}) rows of +-1/3")
    print(f"[hot] vectors file {vocab.size} x {D} of +-1/3")
    return by_path


# ----------------------------- [sweep]: the fused chunk's sweep scatter
def run_sweep(dev, vocab, encoded) -> dict:
    """One S-step chunk of make_fused_train_chunk at the shipped flags
    (B = 8192, D = 200, bf16 fused table, banded 256, context kernel) with
    scatter_impl="sweep" (kernel 9 once per step, its plan built per step
    as in the JAX step) and the same chunk with "span" (kernel 2), from
    one state and one set of injected draws, in turns (sweep, span,
    sweep, span; the second pair timed).  Then the sweep chunk once more
    with kernel 9's plain version in the kernel's place, on the card: the
    table and loss must equal the kernel's chunk bit for bit.  Sweep and
    span round in other places (per (block, id) against per id), and over
    S steps the gap compounds and moves with any other rounding (kernel
    1's order moved it tenfold), so their distance is printed, not held
    to a bound."""
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.pipeline import build_epoch_arrays
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.models.cbow_fused import make_fused_train_chunk
    from word2bits_tpu_torch.models.init import init_fused_table
    from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                      draw_negatives)
    from word2bits_tpu_torch.train import segment_capacity
    cfg = config_from_argv(TRAIN_FLAGS)
    hyper = CBOWHyper(bitlevel=cfg.bitlevel, size=D, window=W, negative=K)
    ea = build_epoch_arrays(encoded, vocab.counts, cfg.sample,
                            vocab.train_words, W,
                            np.random.default_rng(SEED),
                            capacity=segment_capacity(cfg, len(encoded))[1])
    tokens = torch.from_numpy(ea.tokens).to(dev, torch.int64)
    sents = torch.from_numpy(ea.sent_ids).to(dev, torch.int64)
    atab = build_alias_table(vocab.unigram_weights()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
    negs = draw_negatives(gen, atab, (S, B // G, P * K), vocab.size)
    t0 = init_fused_table(vocab.size, D, dtype=torch.bfloat16, device=dev)
    sc = ChunkScalars(base0=W, alpha0=cfg.effective_alpha, wca_start=0.0,
                      wca_per_step=float(B),
                      denom=cfg.iter * float(vocab.train_words) + 1.0)
    out, times, launches = {}, {}, {}
    for impl in ("sweep", "span", "sweep", "span"):
        chunk = make_fused_train_chunk(
            hyper, vocab.size, B, S, neg_sharing=G, neg_pool=P,
            banded=TILE, scatter_impl=impl, context_pallas=True)
        table = t0.clone()
        torch.cuda.synchronize()
        _zero_launches()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        table, loss = chunk(table, tokens, sents, atab, sc, shrinks=shrinks,
                            negs=negs)
        stop.record()
        torch.cuda.synchronize()
        times[impl] = start.elapsed_time(stop) * 1e3 / S
        out[impl] = (table, float(loss))
        if impl == "sweep":
            launches = _read_launches()
    (ts, ls), (tp, lp) = out["sweep"], out["span"]
    if launches["scatter_add_sweep"] != S or \
            launches["fused_context_pallas"] != S:
        _fail(f"sweep chunk: launches {launches} in {S} steps (kernel 9 "
              "and kernel 1 once per step expected)")
    if not (math.isfinite(ls) and math.isfinite(lp)):
        _fail(f"sweep chunk loss {ls}, span {lp}: not finite")
    if torch.equal(ts, t0):
        _fail("the sweep chunk changed nothing")
    from word2bits_tpu_torch.kernels import sweep_scatter
    kernel = sweep_scatter.scatter_add_sweep_planned
    sweep_scatter.scatter_add_sweep_planned = (
        lambda table, plan, rows, window=512, chunk=128:
        sweep_scatter._apply_plain(table, plan, rows, window, chunk))
    try:
        chunk = make_fused_train_chunk(
            hyper, vocab.size, B, S, neg_sharing=G, neg_pool=P,
            banded=TILE, scatter_impl="sweep", context_pallas=True)
        tq, lq = chunk(t0.clone(), tokens, sents, atab, sc, shrinks=shrinks,
                       negs=negs)
        torch.cuda.synchronize()
    finally:
        sweep_scatter.scatter_add_sweep_planned = kernel
    if not torch.equal(_bits(ts), _bits(tq)) or ls != float(lq):
        _fail(f"sweep chunk with kernel 9 against its plain version: tables "
              f"apart by {_max_err(ts, tq):.3e}, losses {ls}/{float(lq)}")
    print(f"[sweep] {S} steps of B={B}, V={vocab.size}: sweep "
          f"{times['sweep']:.1f} us/step, span {times['span']:.1f} us/step "
          f"(second of two turns each); the sweep chunk bit-equal to the "
          f"same chunk through kernel 9's plain version; span's table apart by "
          f"{_max_err(ts, tp):.3e} (bf16, other rounding points, over "
          f"{S} steps; the largest |value| {float(ts.float().abs().max()):.3e}"
          f"), losses "
          f"{ls:.6f}/{lp:.6f} (relative gap {abs(ls - lp) / abs(lp):.3e}); "
          f"launches {launches}")
    return launches


# ------------------------------------- [convert], [nearest]: cli on card
def _neighbours(transcript: str) -> list:
    """[(query line, [(word, similarity)])] of a `cli nearest` transcript."""
    out = []
    for line in transcript.splitlines():
        if line.startswith("  "):
            w, sim = line.split()
            out[-1][1].append((w, float(sim)))
        else:
            out.append((line, []))
    return out


def _same_neighbours(card: str, cpu: str, tie: float = 1e-6) -> int:
    """Fails unless the two transcripts agree apart from the order of
    neighbours whose similarities tie within `tie` (and the sixth decimal
    of a similarity); returns how many positions differ in their word."""
    a, b = _neighbours(card), _neighbours(cpu)
    if [q for q, _ in a] != [q for q, _ in b]:
        _fail("nearest: the card and the CPU answered other queries")
    moved = 0
    for (q, an), (_, bn) in zip(a, b):
        if len(an) != len(bn):
            _fail(f"nearest {q}: {len(an)} neighbours on the card, "
                  f"{len(bn)} on the CPU")
        for i, ((aw, asim), (bw, bsim)) in enumerate(zip(an, bn)):
            if abs(asim - bsim) > 1.5e-6:
                _fail(f"nearest {q} #{i}: {asim} on the card, {bsim} on "
                      "the CPU")
            if aw != bw:
                tied = [w for w, sim in bn if abs(sim - asim) <= tie + 1.5e-6]
                if aw not in tied and i < len(bn) - len(tied):
                    _fail(f"nearest {q} #{i}: {aw} on the card, {bw} on the "
                          "CPU, not a tie")
                moved += 1
    return moved


def _cli(fn, argv, cpu: bool) -> tuple:
    """(return code, stdout, seconds) of a cli entry point, on the card or
    with W2B_FORCE_CPU=1."""
    if cpu:
        os.environ["W2B_FORCE_CPU"] = "1"
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
    finally:
        os.environ.pop("W2B_FORCE_CPU", None)
    return rc, buf.getvalue(), time.perf_counter() - t0


def run_convert_nearest(work: str) -> tuple:
    """`cli convert` and `cli nearest` on a seeded 70,000 x 200 float32
    binary vector file, each on the card and under W2B_FORCE_CPU=1:
    convert with -bitlevel 1 -packed 1, -bitlevel 4 -binary 1 and
    -bitlevel 2 (text), the outputs byte-identical, kernel 4 once per call
    (one block); nearest of 20 words at -bitlevel 1 (kernel 4 once) and 0,
    the transcripts equal apart from ties.  Returns the launch counts of
    the card's convert and nearest calls."""
    import filecmp
    from word2bits_tpu_torch import cli
    from word2bits_tpu_torch.io.vectors import write_vectors
    rng = np.random.default_rng(SEED + 11)
    src = os.path.join(work, "convert_in.bin")
    words = [f"w{i}" for i in range(CONVERT_V)]
    write_vectors(src, words, rng.standard_normal(
        (CONVERT_V, CONVERT_D), dtype=np.float32) * 0.5, binary=True)
    per_call = -(-CONVERT_V // ((1 << 24) // CONVERT_D))
    by_path = {}
    totals = {n: 0 for n in _launch_counters()}
    for flags in CONVERT_CASES:
        dst = {w: os.path.join(work, f"convert_{w}") for w in ("card", "cpu")}
        _zero_launches()
        rc, log, sec = _cli(cli.convert_main, [src, dst["card"], *flags],
                            cpu=False)
        launches = _read_launches()
        rc_cpu, log_cpu, sec_cpu = _cli(cli.convert_main,
                                        [src, dst["cpu"], *flags], cpu=True)
        if rc != 0 or rc_cpu != 0:
            _fail(f"convert {' '.join(flags)} returned {rc} on the card, "
                  f"{rc_cpu} on the CPU")
        if launches["quantize_pallas"] != per_call:
            _fail(f"convert {' '.join(flags)}: kernel 4 launched "
                  f"{launches['quantize_pallas']} times, not {per_call}")
        if not filecmp.cmp(dst["card"], dst["cpu"], shallow=False):
            _fail(f"convert {' '.join(flags)}: the card's file differs from "
                  "the CPU's")
        print(f"[convert] {' '.join(flags)}: {os.path.getsize(dst['card'])} "
              f"bytes, byte-identical to the CPU's; card {sec:.2f} s, CPU "
              f"{sec_cpu:.2f} s; launches {launches['quantize_pallas']} of "
              "kernel 4")
        for n in totals:
            totals[n] += launches[n]
        for path in dst.values():
            os.remove(path)
    by_path["convert"] = totals
    queries = [words[i] for i in rng.integers(0, CONVERT_V, NEAREST_QUERIES)]
    totals = {n: 0 for n in _launch_counters()}
    for bl in ("1", "0"):
        argv = [src, *queries, "-bitlevel", bl, "-topk", "10"]
        _zero_launches()
        rc, card, sec = _cli(cli.nearest_main, argv, cpu=False)
        launches = _read_launches()
        rc_cpu, cpu, sec_cpu = _cli(cli.nearest_main, argv, cpu=True)
        if rc != 0 or rc_cpu != 0:
            _fail(f"nearest -bitlevel {bl} returned {rc}/{rc_cpu}")
        if launches["quantize_pallas"] != (bl != "0"):
            _fail(f"nearest -bitlevel {bl}: kernel 4 launched "
                  f"{launches['quantize_pallas']} times")
        moved = _same_neighbours(card, cpu)
        print(f"[nearest] -bitlevel {bl}: {NEAREST_QUERIES} queries x 10 "
              f"neighbours, {moved} placed otherwise among ties, transcripts "
              f"{'equal' if card == cpu else 'equal apart from ties'}; card "
              f"{sec:.2f} s, CPU {sec_cpu:.2f} s (reading included)")
        for n in totals:
            totals[n] += launches[n]
    by_path["nearest"] = totals
    os.remove(src)
    return by_path


# --------------------------------------------------- [accuracy]: eval
def check_accuracy(dev, path: str, threshold: int, n_q: int,
                   tag: str) -> None:
    """`cli accuracy <path> 0 <threshold>` on the card against the CPU
    evaluator, on a crafted question file: random words among the rows the
    threshold keeps, one in 200 replaced by a word the file does not hold;
    half the covered questions take the CPU evaluator's own prediction as
    their answer.
    A question may come out differently on the card only where its two
    best scores on the CPU are within 1e-5 (ties are common: every
    normalized value at bitlevel 1 is +-1/sqrt(D), and a sum in another
    order can break them another way); any other difference fails."""
    from word2bits_tpu_torch import cli
    from word2bits_tpu_torch.eval import analogy as A
    from word2bits_tpu_torch.io.packed import MAGIC, read_packed
    from word2bits_tpu_torch.io.vectors import read_vectors

    with open(path, "rb") as f:
        packed = f.read(len(MAGIC)) == MAGIC
    if packed:
        words, vecs, _ = read_packed(path, max_words=threshold)
    else:
        words, vecs = read_vectors(path, max_words=threshold)
    V = len(words)
    rng = np.random.default_rng(SEED + 3)
    abcd = rng.integers(1, V, (n_q, 4))
    oov = rng.random((n_q, 4)) < 0.005      # words the file does not hold
    secs = np.arange(n_q) * 8 // n_q
    names = [f"sec{i}" for i in range(8)]
    quads = [(int(secs[i]), *(f"OOV{i}" if oov[i, j]
                              else words[abcd[i, j]].upper()
                              for j in range(4)))
             for i in range(n_q)]
    qs = A.AnalogyQuestions(sections=names, questions=quads)
    t0 = time.perf_counter()
    cpu = A.analogy_predictions(words, vecs, qs, device="cpu", top2=True)
    t_cpu = time.perf_counter() - t0
    # half the covered questions get the CPU's prediction as their answer
    covered = np.flatnonzero(~oov.any(axis=1))
    for k in range(0, len(covered), 2):
        sec, a, b, c, _ = quads[covered[k]]
        quads[covered[k]] = (sec, a, b, c, words[cpu.best[k]].upper())
        cpu.quads[k, 4] = cpu.canon[cpu.best[k]]
    qpath = os.path.join(os.path.dirname(path), f"questions_{tag}.txt")
    with open(qpath, "w", encoding="utf-8") as f:
        for s, name in enumerate(names):
            f.write(f": {name}\n")
            f.writelines(" ".join(q[1:]) + "\n" for q in quads if q[0] == s)
    want_report = A.format_report(A.result_of(cpu, names))

    captured = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = cli.accuracy_main([path, "0", str(threshold), "-questions",
                                qpath])
    t_card = time.perf_counter() - t0
    if rc != 0:
        _fail(f"cli accuracy returned {rc} on {tag}")
    report = captured.getvalue().split("Starting eval...\n", 1)[-1]
    report = report.removesuffix("\n")
    card = A.analogy_predictions(words, vecs, A.load_questions(qpath),
                                 device=dev)
    if A.format_report(A.result_of(card, names)) != report:
        _fail(f"[accuracy {tag}] cli transcript is not the card scorer's")
    if not np.array_equal(card.quads, cpu.quads):
        _fail(f"[accuracy {tag}] the card and the CPU resolved different "
              "questions")
    differ = ((cpu.canon[card.best] != cpu.canon[cpu.best])
              | ((card.best_score > 0) != (cpu.best_score > 0)))
    near = (cpu.best_score - cpu.second_score) <= 1e-5
    if (differ & ~near).any():
        i = int(np.flatnonzero(differ & ~near)[0])
        _fail(f"[accuracy {tag}] question {i} differs on the card (row "
              f"{card.best[i]}, {card.best_score[i]}) from the CPU (row "
              f"{cpu.best[i]}, {cpu.best_score[i]}; runner-up "
              f"{cpu.second_score[i]})")
    for line in report.splitlines()[-2:]:
        print(f"[accuracy {tag}] card: {line}")
    for line in want_report.splitlines()[-2:]:
        print(f"[accuracy {tag}] CPU:  {line}")
    print(f"[accuracy {tag}] {V} rows, {len(cpu.best)} of {n_q} questions "
          f"covered; {int(near.sum())} near ties on the CPU (two best "
          f"within 1e-5), {int(differ.sum())} answered differently on the "
          f"card, all near ties; transcripts "
          f"{'equal' if report == want_report else 'differ only there'}; "
          f"card {t_card:.1f} s (cli, reading included), CPU {t_cpu:.1f} s")


# --------------------------------------------- [native]: the C++ tokenizer
def check_native(corpus: str, flag_vocab) -> None:
    """The native library built with g++ from native/tokenizer.cpp (a
    failed build fails the run: use_native=True), then count_words and
    encode_corpus on [train]'s 17M-token corpus equal to the Python
    path's, build_alias_table at the flagship's V = 3,699,941 bit-equal
    both ways, and 16M draws of the LCG fill equal; each timed both
    ways."""
    from word2bits_tpu_torch import native
    from word2bits_tpu_torch.data.corpus import count_words, encode_corpus
    from word2bits_tpu_torch.data.vocab import Vocab
    from word2bits_tpu_torch.sampling.unigram import build_alias_table
    from word2bits_tpu_torch.utils.lcg import lcg_uniform_block

    t0 = time.perf_counter()
    native.build(fresh=True)
    native._cache.clear()
    native.load()
    t_build = time.perf_counter() - t0
    times = {}

    def both(name, fn):
        out = []
        for way in (True, False):
            t0 = time.perf_counter()
            out.append(fn(way))
            times[(name, way)] = time.perf_counter() - t0
        return out

    cn, cp = both("count", lambda w: count_words(corpus, use_native=w))
    if cn != cp:
        _fail("native count_words differs from the Python path's")
    vocab = Vocab.from_counts(cp, min_count=5)
    en, ep = both("encode", lambda w: encode_corpus(corpus, vocab,
                                                    use_native=w))
    if en.dtype != ep.dtype or not np.array_equal(en, ep):
        _fail("native encode_corpus differs from the Python path's")
    weights = flag_vocab.unigram_weights()
    an, ap = both("alias", lambda w: build_alias_table(weights,
                                                       use_native=w))
    if not (torch.equal(an.prob, ap.prob) and torch.equal(an.alias,
                                                          ap.alias)):
        _fail("native alias table differs from the Python path's at "
              f"V = {weights.shape[0]}")
    ln, lp = both("lcg", lambda w: lcg_uniform_block(12_345, 1 << 24,
                                                     use_native=w))
    if not np.array_equal(ln, lp):
        _fail("native LCG fill differs from the numpy path's")
    t = {k: f"{v:.3f}" for k, v in times.items()}
    print(f"[native] g++ build {t_build:.2f} s; count_words of "
          f"{CORPUS_TOKENS} tokens ({len(cp)} types) native "
          f"{t[('count', True)]} s, Python {t[('count', False)]} s; "
          f"encode_corpus ({en.size} ids) native {t[('encode', True)]} s, "
          f"Python {t[('encode', False)]} s; alias table at V = "
          f"{weights.shape[0]} native {t[('alias', True)]} s, Python "
          f"{t[('alias', False)]} s; LCG fill of {1 << 24} draws native "
          f"{t[('lcg', True)]} s, numpy {t[('lcg', False)]} s; all equal "
          f"({_card_line()})")


# ------------------------------------ [device epoch]: epochs on the card
def check_device_epoch(dev, vocab, encoded, B_: int, S_: int,
                       tag: str) -> None:
    """build_with_uniforms on the card bit-equal to the host
    build_epoch_arrays on the same float32 uniforms (numpy, seeded), at
    the capacity train.segment_capacity gives (B_, S_); the card's build
    (CUDA events, uniforms given and drawn from a card generator) timed
    beside the host's."""
    from word2bits_tpu_torch.data.device_pipeline import (
        build_with_uniforms, make_device_epoch_builder)
    from word2bits_tpu_torch.data.pipeline import (build_epoch_arrays,
                                                   subsample_keep_probs)
    n = encoded.size
    cap = ((n + S_ * B_ + 8 + 1023) // 1024) * 1024
    uni = np.random.default_rng(SEED + 7).random(n, dtype=np.float32)
    kp = subsample_keep_probs(vocab.counts, 1e-3, vocab.train_words)
    t0 = time.perf_counter()
    host = build_epoch_arrays(encoded, vocab.counts, 1e-3,
                              vocab.train_words, W, None, capacity=cap,
                              uniforms=uni)
    t_host = time.perf_counter() - t0
    enc_d = torch.from_numpy(np.asarray(encoded, np.int32)).to(dev)
    kp_d = torch.from_numpy(kp.astype(np.float32)).to(dev)
    uni_d = torch.from_numpy(uni).to(dev)
    tok, sen, nt = build_with_uniforms(cap, W, enc_d, kp_d, uni_d,
                                       device=dev)
    if (int(nt) != host.n_tokens
            or not np.array_equal(tok.cpu().numpy(), host.tokens)
            or not np.array_equal(sen.cpu().numpy(), host.sent_ids)):
        bad = int((tok.cpu().numpy() != host.tokens).sum())
        _fail(f"{tag}: the device epoch differs from the host build "
              f"({int(nt)} vs {host.n_tokens} kept, {bad} tokens differ)")
    ms = _time_ms(lambda: build_with_uniforms(cap, W, enc_d, kp_d, uni_d,
                                              device=dev), reps=5, warmup=1)
    build = make_device_epoch_builder(cap, W)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ms_gen = _time_ms(lambda: build(enc_d, kp_d, gen), reps=5, warmup=1)
    print(f"[device epoch] {tag}: {n} tokens over V = {vocab.size}, "
          f"{host.n_tokens} kept, capacity {cap}: bit-equal to the host "
          f"build; card {ms:.3f} ms (uniforms given), {ms_gen:.3f} ms "
          f"(drawn on the card), host {t_host * 1e3:.1f} ms "
          f"({_card_line()})")


# ------------------------------------------------ [skipgram]: skip-gram
def check_skipgram_step(dev) -> None:
    """One skip-gram step and a 3-step chunk on the card against the same
    calls on the CPU, at a small shape with injected draws, float32
    tables: atol 1e-4 + rtol 1e-4, loss rtol 1e-5 (as [step]); per-center,
    shared with 2 pools, dense-hot, and per pair (-neg-per-pair 1: 2W*K
    draws a center)."""
    from word2bits_tpu_torch.models import cbow_slab as cs
    from word2bits_tpu_torch.models import skipgram as sg
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                      build_stratified_tables)
    rng = np.random.default_rng(SEED + 11)
    v, d, b, w, k, h, s = 300, 16, 64, 3, 5, 32, 3
    n = s * b + 2 * w + 10
    tokens = torch.from_numpy(rng.integers(0, v, n))
    tokens[:w] = -1
    sents = torch.arange(n) // 23
    sents[:w] = -1
    shrinks = torch.from_numpy(rng.integers(0, w, (s, b)))
    u0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (v, d)).astype(np.float32))
    v0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (v, d)).astype(np.float32))
    sc = ChunkScalars(base0=w, alpha0=0.05, wca_start=100.0,
                      wca_per_step=float(b), denom=1e4)
    st = build_stratified_tables(np.arange(v, 0, -1.0) ** 0.75, h)
    dense = st.dense_split(k)
    for name, gg, pp, dh, npp in (("per-center", 0, 1, False, False),
                                  ("shared, 2 pools", 8, 2, False, False),
                                  ("dense-hot", 0, 1, True, False),
                                  ("per pair", 0, 1, False, True)):
        kk = dense[0] if dh else k
        hyper = CBOWHyper(bitlevel=1, size=d, window=w, negative=kk)
        rows = b // gg if gg else b
        lanes = 2 * w * kk if npp else pp * kk
        negs = torch.from_numpy(rng.integers(h if dh else 1, v,
                                             (s, rows, lanes)))
        outs = {}
        for where in ("cpu", dev):
            step_dense = ((dense[1], torch.from_numpy(dense[2]).to(where))
                          if dh else None)
            st_in = cs.SlabInputs(
                tokens[:b + 2 * w].to(where), sents[:b + 2 * w].to(where),
                shrinks[0].to(where), negs[0].to(where))
            su, sv, loss = sg.skipgram_slab_step(
                u0.clone().to(where), v0.clone().to(where), st_in,
                torch.tensor(0.05, device=where), hyper, b, gg,
                neg_pool=pp, dense_hot=step_dense, neg_per_pair=npp)
            chunk = sg.make_skipgram_train_chunk(
                hyper, v, b, s, neg_sharing=gg, neg_pool=pp,
                hot_rows=h if dh else 0, dense_hot=dense if dh else None,
                neg_per_pair=npp)
            atab = (st.cold if dh else build_alias_table(np.ones(v))
                    ).to(where)
            cu, cv, closs = chunk(u0.clone().to(where), v0.clone().to(where),
                                  tokens.to(where), sents.to(where), atab,
                                  sc, shrinks=shrinks.to(where),
                                  negs=negs.to(where))
            outs[str(where)] = ([su.cpu(), sv.cpu()], float(loss),
                                [cu.cpu(), cv.cpu()], float(closs))
        (t0_, l0, c0, cl0), (t1, l1, c1, cl1) = outs["cpu"], outs[str(dev)]
        errs = []
        for what, a, bb in (("step", t1, t0_), ("chunk", c1, c0)):
            for x, y in zip(a, bb):
                if not torch.allclose(x, y, atol=1e-4, rtol=1e-4):
                    _fail(f"skipgram {name} {what} on the card vs the CPU: "
                          f"max abs err {_max_err(x, y):.3e}")
                errs.append(_max_err(x, y))
        for what, a, bb in (("step loss", l1, l0), ("chunk loss", cl1, cl0)):
            if abs(a - bb) > 1e-5 * abs(bb) + 1e-6:
                _fail(f"skipgram {name} {what} on the card {a} vs the CPU "
                      f"{bb}")
        print(f"[skipgram] {name} card vs CPU: step and chunk max abs err "
              f"{max(errs):.3e}, losses {l1:.6f}/{l0:.6f}, "
              f"{cl1:.6f}/{cl0:.6f}")


def run_skipgram(work: str, dev, vocab, encoded) -> dict:
    """The Quick start's flags with -model skipgram (size 200, window 8,
    negative 24, bitlevel 1, B auto = 256, float32) through train.train on
    [quickstart]'s corpus, SG_STEPS steps, its vectors written (kernel 4)
    and read back; then the same with -hot-rows 2048 -neg-dense-hot 1 on
    bf16.  Prints µs/step on the card's clock and the per-step loss of
    each chunk."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.io.vectors import read_vectors
    by_path = {}
    out = os.path.join(work, "skipgram.bin")
    for tag, extra in (("skipgram", []),
                       ("skipgram_densehot",
                        ["-hot-rows", str(HOT), "-neg-dense-hot", "1",
                         "-dtype", "bfloat16"])):
        cfg = config_from_argv(QUICKSTART_FLAGS + SG_FLAGS + extra
                               + ["-output", out, "-debug", "1"])
        _zero_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            res = T.train(cfg, vocab=vocab, encoded=encoded,
                          max_steps=SG_STEPS, device=dev)
        launches = _read_launches()
        if res.steps != SG_STEPS or len(res.tables) != 2:
            _fail(f"{tag} trained {res.steps} steps on {len(res.tables)} "
                  f"tables, not {SG_STEPS} on split tables")
        per_step = [x / cfg.steps_per_chunk for x in res.chunk_losses]
        if not all(math.isfinite(x) for x in per_step + res.epoch_losses):
            _fail(f"{tag} loss not finite: {per_step}")
        if launches["quantize_pallas"] <= 0:
            _fail(f"{tag}: the export did not launch kernel 4")
        words, vecs = read_vectors(out)
        third = np.float32(1.0) / np.float32(3.0)
        if (vecs.shape != (vocab.size, D) or words != vocab.words
                or not np.all(np.abs(vecs) == third)):
            _fail(f"{tag} vectors file holds {vecs.shape}, not "
                  f"({vocab.size}, {D}) rows of +-1/3")
        us, wps = _steady(res)
        print(f"[skipgram] {' '.join(extra) or 'the Quick start flags'}: "
              f"{res.steps} steps of B={cfg.batch_size}, {cfg.dtype}, "
              f"{us:.1f} us/step, {wps:.1f} words/sec (card clock, chunks "
              f"after the first); loss per step by chunk "
              f"{[round(x, 1) for x in per_step]}; launches {launches}; "
              f"vectors file {vocab.size} x {D} of +-1/3 ({_card_line()})")
        by_path[tag] = launches
        del res
    return by_path


# ------------------------------------------------------ [tune]: cli tune
def run_tune(corpus: str) -> dict:
    """`cli tune` on [train]'s corpus at TUNE_FLAGS with -tune-seconds 2
    -json 1: every variant measured (none reports an error), kernels 1, 2
    and 6 launched on the way."""
    from word2bits_tpu_torch import cli
    _zero_launches()
    rc, out, sec = _cli(cli.tune_main, ["-train", corpus] + TUNE_FLAGS
                        + ["-tune-seconds", "2", "-json", "1"], cpu=False)
    launches = _read_launches()
    if rc != 0:
        _fail(f"cli tune returned {rc}:\n{out[-2000:]}")
    result = json.loads(out.strip().splitlines()[-1])
    rows = result["rows"]
    bad = [r for r in rows if "words_per_sec" not in r]
    if bad or len(rows) < 2:
        _fail(f"cli tune measured {len(rows) - len(bad)} of {len(rows)} "
              f"variants: {bad}")
    for name in ("fused_context_pallas", "scatter_add_span",
                 "hot_slice_add_pallas"):
        if launches[name] <= 0:
            _fail(f"cli tune launched {name} no time")
    rates = ", ".join(f"{r['name']} {r['words_per_sec']:.1f}" for r in rows)
    print(f"[tune] {len(rows)} variants in {sec:.1f} s, words/sec on the "
          f"card's clock: {rates}; recommended {result['recommended']} "
          f"({result['flags'] or 'as given'}); launches {launches} "
          f"({_card_line()})")
    return launches


# --------------------------------------------- [profile]: -profile-dir
def run_profile(work: str, dev, vocab, encoded) -> dict:
    """One S-step chunk of the shipped flags through train.train with
    -profile-dir: the Chrome trace must be written and name kernels 1 and
    2 (context_kernel, tile_scatter_kernel)."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    pdir = os.path.join(work, "profile")
    cfg = config_from_argv(TRAIN_FLAGS + ["-profile-dir", pdir])
    _zero_launches()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = T.train(cfg, vocab=vocab, encoded=encoded, max_steps=S,
                      device=dev)
    launches = _read_launches()
    files = [f for f in os.listdir(pdir) if f.endswith(".json")]
    if res.steps != S or len(files) != 1:
        _fail(f"profile: {res.steps} steps, trace files {files}:\n"
              f"{log.getvalue()[-2000:]}")
    path = os.path.join(pdir, files[0])
    with open(path) as f:
        trace = f.read()
    named = [k for k in ("context_kernel", "tile_scatter_kernel")
             if k in trace]
    if not named:
        _fail("profile: the trace names none of the port's kernels")
    print(f"[profile] one {S}-step chunk traced to {files[0]} "
          f"({os.path.getsize(path)} bytes), naming {named}; launches "
          f"{launches}")
    return launches


# ------------------------------------------- [parity]: run-level accuracy
def run_parity(dev) -> dict:
    """Per-center bitlevel 0 and skip-gram bitlevel 1, seed 1, on the
    30,000-sentence structured corpus (5 epochs), trained on the card by
    word2bits_tpu_torch/tools/accuracy_parity.py's run_port and scored by
    the port's evaluator: each accuracy at or above PARITY_FLOORS (the
    JAX package's mean - 3 sd on that corpus, on the CPU)."""
    from word2bits_tpu_torch.tools import accuracy_parity as AP
    corpus, questions = AP.ensure_corpus(fast=True)
    by_path = {}
    for row, (floor, jm, js) in PARITY_FLOORS.items():
        bitlevel, mode, fields, *_ = AP.ROWS[row]
        out = os.path.join(os.path.dirname(corpus), f"smoke_{row}.bin")
        _zero_launches()
        sec = AP.run_port(corpus, out, bitlevel, mode, fields, 1,
                          AP.HYPER["iters"], dev)
        by_path[f"parity_{row}"] = _read_launches()
        acc, cov = AP.evaluate(out, questions, dev)
        os.unlink(out)
        if not acc >= floor:
            _fail(f"parity {row}: accuracy {acc:.1f} below the floor "
                  f"{floor:.1f} (JAX {jm:.2f}±{js:.2f})")
        print(f"[parity] {row}, seed 1, 30,000 sentences, 5 epochs: "
              f"{acc:.1f}% (coverage {cov:.1f}%) in {sec:.1f} s, floor "
              f"{floor:.1f} (the JAX package on the CPU {jm:.2f}±{js:.2f}, "
              f"seeds 1-5) ({_card_line()})")
    return by_path


# ------------------------------------------------ [mesh]: parallel/
def _drop_flags(flags: list, names: tuple) -> list:
    """`flags` (flag, value pairs) without the pairs of `names`."""
    return [f for i in range(0, len(flags), 2)
            if flags[i] not in names for f in flags[i:i + 2]]


# The slice's path: the shipped flags on the (data, vocab) mesh trainer, on
# split tables (the JAX trainer ignores -fused-tables on a mesh) without
# the context kernel (-context-pallas is single-chip): kernel 2 once per
# table per step on each shard's local ids.  (a) runs it through `cli
# train` as a mesh of one shard, on a one-rank NCCL group.
MESH_FLAGS = (_drop_flags(TRAIN_FLAGS, ("-fused-tables", "-context-pallas"))
              + ["-mesh-shape", "data=1,vocab=1"])
# (b): meshes larger than the card, every shard in this process
MESH_LOCAL = ((2, 2), (1, 4))
# (c): the capacity form, docs/large_vocab.md:34 on the mesh: kernel 8
# twice a step on the shard (no -context-pallas, as above)
MESH_RMW_FLAGS = (_drop_flags(RMW_FLAGS, ("-context-pallas",))
                  + ["-mesh-shape", "vocab=1", "-debug", "1"])
MESH_RMW_STEPS = 16
MESH_CAP_NV, MESH_CAP_STEPS = 4, 8      # (d): vocab = 4 at capacity
# (d)'s hold, (|d|_F / |ref|_F of each table, loss relative): the same
# update rows, an id's bf16-rounded sum flipping by an ulp here and there
MESH_CAP_TOL = (1e-3, 1e-4)


@contextlib.contextmanager
def _kept_results():
    """train.train wrapped to keep its TrainResult (cli.train_main, which
    calls it, returns only an exit code)."""
    from word2bits_tpu_torch import train as T
    orig, kept = T.train, []

    def keep(*args, **kw):
        kept.append(orig(*args, **kw))
        return kept[-1]

    T.train = keep
    try:
        yield kept
    finally:
        T.train = orig


def _mesh_backend(log: str, nd: int, nv: int) -> str:
    m = re.search(rf"Mesh: data={nd} x vocab={nv}, rank 0 of {nd * nv}, "
                  r"backend (\w+)", log)
    if not m:
        _fail("the mesh run printed no Mesh: line")
    if torch.distributed.is_initialized():
        _fail("the mesh run left its process group alive")
    return m.group(1)


def run_mesh_train(work: str, corpus: str) -> tuple:
    """(a) `cli train` at MESH_FLAGS for one epoch of [train]'s corpus, a
    mesh of one shard on a one-rank NCCL group: kernel 2 twice a step,
    the vectors read back; words/sec and us/step on the card's clock."""
    from word2bits_tpu_torch import cli
    from word2bits_tpu_torch.io.vectors import read_vectors
    out = os.path.join(work, "mesh.bin")
    captured = io.StringIO()
    _zero_launches()
    with _kept_results() as kept, \
            contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
        rc = cli.train_main(["-train", corpus, "-output", out] + MESH_FLAGS)
    launches = _read_launches()
    if rc != 0 or len(kept) != 1:
        _fail(f"mesh cli train returned {rc}")
    backend = _mesh_backend(captured.getvalue(), 1, 1)
    if backend != "nccl":
        _fail(f"the mesh ran on {backend}, not nccl")
    res = kept[0]
    if launches["scatter_add_span"] != 2 * res.steps or res.steps < S:
        _fail(f"mesh: kernel 2 launched {launches['scatter_add_span']} "
              f"times in {res.steps} steps (twice a step expected)")
    if not all(math.isfinite(x) for x in res.epoch_losses):
        _fail(f"mesh epoch loss not finite: {res.epoch_losses}")
    words, vecs = read_vectors(out)
    V = res.vocab.size
    third = np.float32(1.0) / np.float32(3.0)
    if (vecs.shape != (V, D) or words != res.vocab.words
            or not np.all(np.abs(vecs) == third)):
        _fail(f"mesh vectors file holds {vecs.shape}, not ({V}, {D}) "
              "rows of +-1/3")
    us, wps = _steady(res)
    print(f"[mesh] (a) cli train -mesh-shape data=1,vocab=1 on {backend}: "
          f"{res.steps} steps of B={B}, V={V}, loss "
          f"{res.epoch_losses[-1]:.4f}; card clock {us:.1f} us/step, "
          f"{wps:.1f} words/sec (chunks after the first); whole loop "
          f"{res.words_per_sec:.1f} words/sec; launches {launches}; vectors "
          f"file {V} x {D} of +-1/3")
    return launches, dict(us_per_step=us, words_per_sec=wps,
                          steps=res.steps)


def _epoch(vocab, encoded, dev, B_: int, S_: int, W_: int):
    """One host-built epoch of `encoded` ((tokens, sents) int64 on dev)
    covering S_ steps of B_ centers."""
    from word2bits_tpu_torch.data.pipeline import build_epoch_arrays
    cap = ((len(encoded) + S_ * B_ + 8 + 1023) // 1024) * 1024
    ep = build_epoch_arrays(encoded, vocab.counts, 1e-3, vocab.train_words,
                            W_, np.random.default_rng(SEED), capacity=cap)
    if ep.n_tokens < S_ * B_:
        _fail(f"epoch of {ep.n_tokens} centers, fewer than {S_} steps")
    return (torch.from_numpy(ep.tokens).to(dev, torch.int64),
            torch.from_numpy(ep.sent_ids).to(dev, torch.int64))


def _errs(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max |a - b|, |a - b|_F / |b|_F), in row blocks."""
    mx, num, den = 0.0, 0.0, 0.0
    for r0 in range(0, a.shape[0], 1 << 18):
        x, y = a[r0:r0 + (1 << 18)].float(), b[r0:r0 + (1 << 18)].float()
        d = x - y
        mx = max(mx, float(d.abs().max()))
        num += float((d * d).sum())
        den += float((y * y).sum())
    return mx, math.sqrt(num / max(den, 1e-30))


def _shard_rows(t: torch.Tensor, nv: int, vi: int) -> torch.Tensor:
    """Vocab shard vi's rows of table t (padded to a multiple of nv), a
    copy on t's device."""
    Vs = -(-t.shape[0] // nv)
    out = torch.zeros((Vs, t.shape[1]), dtype=t.dtype, device=t.device)
    rows = t[vi * Vs:(vi + 1) * Vs]
    out[:rows.shape[0]] = rows
    return out


def _local_mesh_chunk(dev, nd: int, nv: int, u0, v0, steps: int, kw: dict,
                      hyper, V: int, B_: int, inputs, chunk_steps: int):
    """The sharded chunk on a LocalMesh of nd x nv shards on the card, from
    (u0, v0), `steps` steps in chunks of chunk_steps with the injected
    draws: whole (u, v) (each vocab shard's rows), the loss sum, the
    launches of the run and its ms on the card's clock."""
    from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
    from word2bits_tpu_torch.parallel.mesh import LocalMesh
    from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body
    tokens, sents, atab, scalars, shrinks, negs = inputs
    Vp = -(-V // nv) * nv
    chunk = make_sharded_chunk(_sharded_slab_body, hyper, LocalMesh(nd, nv),
                               Vp, V, B_, chunk_steps, **kw)
    shards = [(_shard_rows(u0, nv, r % nv), _shard_rows(v0, nv, r % nv))
              for r in range(nd * nv)]

    def shard(comm):
        ul, vl = shards[comm.rank]
        loss = torch.zeros((), device=dev)
        for c in range(0, steps, chunk_steps):
            sc = scalars._replace(base0=scalars.base0 + c * B_,
                                  wca_start=scalars.wca_start
                                  + c * scalars.wca_per_step)
            ul, vl, part = chunk(comm, ul, vl, tokens, sents, atab, sc,
                                 shrinks=shrinks[c:c + chunk_steps],
                                 negs=negs[c:c + chunk_steps])
            loss = loss + part
        return ul, vl, loss

    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    _zero_launches()
    start.record()
    res = LocalMesh(nd, nv, dev).run(shard)
    stop.record()
    torch.cuda.synchronize()
    launches = _read_launches()
    ms = start.elapsed_time(stop)
    u = torch.cat([res[vi][0] for vi in range(nv)])[:V]
    v = torch.cat([res[vi][1] for vi in range(nv)])[:V]
    return u, v, float(res[0][2]), launches, ms


# (b)'s holds against the single-device chunk.  Bitlevel-1 training is
# chaotic in the signs of the table entries: two runs whose sums differ in
# their last bits (the single device's own `add` and `span` scatters, or
# a mesh's per-shard partial sums) follow each other until an entry near
# zero takes another sign, after which the tables part by 10-50% of their
# norms within ~50 steps (PERF.md section 6; tools/mesh_divergence.py).
# So every step of the chunk is held from the single device's state (the
# shards refilled from it before the step): float32 to 1e-5 of the table
# scale, bf16 to 2^-8 of the tables' norm (the per-shard rounding of
# partial update rows, about a bf16 ulp); the loss to 1e-5 and 1e-4.  The
# 256-step bf16 chunk (the path, its launches counted) is held by its
# loss, to 1%.
RESYNC_TOL = {torch.float32: (1e-5, None, 1e-5),
              torch.bfloat16: (None, 2.0 ** -8, 1e-4)}
CHUNK_LOSS_TOL = 1e-2


def _resync_hold(dev, nd: int, nv: int, dtype, hyper, V: int, inputs,
                 kw: dict) -> tuple:
    """Every step of the chunk through the LocalMesh from the single
    device's state: (worst max |d| over the table scale, worst |d|_F /
    |ref|_F, worst loss relative difference) over the steps."""
    from word2bits_tpu_torch.models.cbow_slab import make_slab_train_chunk
    from word2bits_tpu_torch.models.init import init_params
    from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
    from word2bits_tpu_torch.parallel.mesh import LocalMesh
    from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body
    tokens, sents, atab, scalars, shrinks, negs = inputs
    n = shrinks.shape[0]
    Vs = -(-V // nv)
    single = make_slab_train_chunk(hyper, V, B, 1, **kw)
    lm = LocalMesh(nd, nv, dev)
    chunk = make_sharded_chunk(_sharded_slab_body, hyper, lm, Vs * nv, V, B,
                               1, **kw)
    ru, rv = init_params(V, D, dtype=dtype, device=dev)
    shards = [(torch.empty((Vs, D), dtype=dtype, device=dev),
               torch.empty((Vs, D), dtype=dtype, device=dev))
              for _ in range(nd * nv)]
    worst = [0.0, 0.0, 0.0]
    for s in range(n):
        sc = scalars._replace(base0=W + s * B,
                              wca_start=s * scalars.wca_per_step)
        for r, (su, sv) in enumerate(shards):
            vi = r % nv
            su.copy_(_shard_rows(ru, nv, vi))
            sv.copy_(_shard_rows(rv, nv, vi))

        def step(comm):
            su, sv = shards[comm.rank]
            return chunk(comm, su, sv, tokens, sents, atab, sc,
                         shrinks=shrinks[s:s + 1], negs=negs[s:s + 1])[2]

        m_loss = float(lm.run(step)[0])
        ru, rv, r_loss = single(ru, rv, tokens, sents, atab, sc,
                                shrinks=shrinks[s:s + 1],
                                negs=negs[s:s + 1])
        scale = max(1.0, float(ru.float().abs().max()),
                    float(rv.float().abs().max()))
        for i, ref in ((0, ru), (1, rv)):
            got = torch.cat([shards[vi][i] for vi in range(nv)])[:V]
            mx, rel = _errs(got, ref)
            worst[0] = max(worst[0], mx / scale)
            worst[1] = max(worst[1], rel)
        worst[2] = max(worst[2], abs(m_loss - float(r_loss))
                       / abs(float(r_loss)))
    return tuple(worst)


def check_local_mesh(dev, vocab, encoded) -> dict:
    """(b) LocalMesh 2 x 2 and 1 x 4 on the card at the path's widths
    (MESH_FLAGS: B = 8192, D = 200, 2 pools, banded 256, span), every
    shard's kernel 2 on its local ids: one 256-step bf16 chunk (the path:
    its launches and time), its loss held to the single-device chunk's on
    the same draws; every step of it held from the single device's state
    in float32 and bf16 (RESYNC_TOL); kernel 2's time on one shard's
    step-0 lists beside the single card's."""
    from word2bits_tpu_torch.kernels.span_scatter import (
        scatter_add_span_planned, sort_plan)
    from word2bits_tpu_torch.models.cbow import (CBOWHyper, ChunkScalars,
                                                 chunk_slabs)
    from word2bits_tpu_torch.models.cbow_slab import make_slab_train_chunk
    from word2bits_tpu_torch.models.init import init_params
    from word2bits_tpu_torch.parallel.chunk import gathered_update_ids
    from word2bits_tpu_torch.parallel.sharded_slab import to_local
    from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                      draw_negatives)
    V = vocab.size
    tokens, sents = _epoch(vocab, encoded, dev, B, S, W)
    atab = build_alias_table(vocab.unigram_weights()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
    negs = draw_negatives(gen, atab, (S, B // G, P * K), V)
    scalars = ChunkScalars(base0=W, alpha0=0.1, wca_start=0.0,
                           wca_per_step=float(B),
                           denom=float(vocab.train_words) + 1.0)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    kw = dict(neg_sharing=G, neg_pool=P, banded=TILE, scatter_impl="span")
    inputs = (tokens, sents, atab, scalars, shrinks, negs)
    out = {"launches": {}}
    u, v = init_params(V, D, dtype=torch.bfloat16, device=dev)
    chunk = make_slab_train_chunk(hyper, V, B, S, **kw)
    ru, rv, rloss = chunk(u, v, tokens, sents, atab, scalars,
                          shrinks=shrinks, negs=negs)
    rloss = float(rloss)
    for nd, nv in MESH_LOCAL:
        tag = f"{nd}x{nv}"
        u0, v0 = init_params(V, D, dtype=torch.bfloat16, device=dev)
        mu, mv, loss, launches, ms = _local_mesh_chunk(
            dev, nd, nv, u0, v0, S, kw, hyper, V, B, inputs, S)
        del u0, v0
        eu, ev = _errs(mu, ru), _errs(mv, rv)
        el = abs(loss - rloss) / abs(rloss)
        del mu, mv
        if launches["scatter_add_span"] != 2 * S * nd * nv:
            _fail(f"mesh {tag}: kernel 2 launched "
                  f"{launches['scatter_add_span']} times, not "
                  f"{2 * S * nd * nv} (twice a step on each shard)")
        print(f"[mesh] (b) LocalMesh {tag}: {S} bf16 steps of B={B} in "
              f"{ms:.1f} ms on the card ({ms / S * 1e3:.1f} us/step, all "
              f"{nd * nv} shards), loss {loss:.4f}, {el:.6g} from the single "
              f"device's (tolerance {CHUNK_LOSS_TOL}); tables after the "
              f"chunk (chaotic, not held): u max {eu[0]:.6g} rel {eu[1]:.6g},"
              f" v max {ev[0]:.6g} rel {ev[1]:.6g}; launches {launches}")
        if not el <= CHUNK_LOSS_TOL:
            _fail(f"mesh {tag}: chunk loss {el} from the single device's")
        out["launches"][tag] = launches
        out[tag] = dict(us_per_step=ms / S * 1e3, chunk_err=(eu, ev, el))
        for dtype, (t_max, t_rel, t_loss) in RESYNC_TOL.items():
            worst = _resync_hold(dev, nd, nv, dtype, hyper, V, inputs, kw)
            dname = str(dtype).split(".")[-1]
            print(f"[mesh] (b) LocalMesh {tag}, every step from the single "
                  f"device's state, {dname}: worst max/scale {worst[0]:.6g},"
                  f" rel {worst[1]:.6g}, loss rel {worst[2]:.6g}; tolerance "
                  f"({t_max}, {t_rel}, {t_loss})")
            if ((t_max is not None and worst[0] > t_max)
                    or (t_rel is not None and worst[1] > t_rel)
                    or worst[2] > t_loss):
                _fail(f"mesh {tag} {dname}: a step outside its tolerance")
            out[tag][f"resync_{dname}"] = worst
    del ru, rv
    # kernel 2 on the step-0 lists of vocab shards 0 (the Zipf head) and
    # nv - 1 against the single card's
    slab = chunk_slabs(tokens, sents, W, 1, B, W)[0].clamp_min(0)
    single_ids = gathered_update_ids(slab, negs[:1], 1, W, G)
    for nd, nv in MESH_LOCAL:
        tag, Vs = f"{nd}x{nv}", -(-V // nv)
        times = {}
        for name, ids_m, ids_1 in zip(
                ("u", "v"), gathered_update_ids(slab, negs[:1], nd, W, G),
                single_ids):
            plan_1 = sort_plan(ids_1[0])
            tab_1 = torch.zeros((V, D), dtype=torch.bfloat16, device=dev)
            rows_1 = torch.randn((ids_1.shape[1], D), device=dev) * 1e-3
            t = times[name] = dict(single_ms=_time_ms(
                lambda: scatter_add_span_planned(tab_1, plan_1, rows_1)),
                single_slots=int(ids_1.shape[1]))
            for vi in (0, nv - 1):
                loc = to_local(ids_m[0], vi, Vs)
                plan_s = sort_plan(loc)
                tab_s = torch.zeros((Vs, D), dtype=torch.bfloat16,
                                    device=dev)
                rows_s = torch.randn((loc.shape[0], D), device=dev) * 1e-3
                t[f"shard{vi}_ms"] = _time_ms(
                    lambda: scatter_add_span_planned(tab_s, plan_s, rows_s))
                t[f"shard{vi}_sentinels"] = int((loc >= Vs).sum())
                t["slots"] = int(loc.shape[0])
            print(f"[mesh] (b) {tag} kernel 2, {name} table, step 0: vocab "
                  f"shard 0 {t['shard0_ms']:.5f} ms ({t['slots']} slots, "
                  f"{t['shard0_sentinels']} sentinels), shard {nv - 1} "
                  f"{t[f'shard{nv - 1}_ms']:.5f} ms "
                  f"({t[f'shard{nv - 1}_sentinels']} sentinels); the single "
                  f"card {t['single_ms']:.5f} ms ({t['single_slots']} slots)")
        out[tag]["kernel2"] = times
    torch.cuda.empty_cache()
    return out


def run_mesh_capacity(dev, vocab, encoded) -> tuple:
    """(c) MESH_RMW_FLAGS through train.train for MESH_RMW_STEPS steps, a
    mesh of one shard on a one-rank NCCL group: kernel 8 twice a step,
    peak device memory <= 1.25 x the table.  (d) LocalMesh vocab = 4 at the
    capacity width for MESH_CAP_STEPS one-step chunks, held to (c)'s mesh
    chunk (the one-rank NCCL group, vocab = 1) over the same steps and
    draws (MESH_CAP_TOL); kernel 8's time on one shard's step-0 lists
    beside the single card's."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.kernels.scatter_pallas import scatter_add_rmw
    from word2bits_tpu_torch.models.cbow import (CBOWHyper, ChunkScalars,
                                                 chunk_slabs)
    from word2bits_tpu_torch.models.init import init_params
    from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
    from word2bits_tpu_torch.parallel.sharded_slab import (_sharded_slab_body,
                                                           to_local)
    from word2bits_tpu_torch.parallel.trainer import mesh_session
    from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                      draw_negatives)
    cfg = config_from_argv(MESH_RMW_FLAGS)
    V, Dd, Bc = vocab.size, FLAG_D, FLAG_B
    table_bytes = V * 2 * Dd * 2
    captured = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    with contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
        res = T.train(cfg, vocab=vocab, encoded=encoded,
                      max_steps=MESH_RMW_STEPS, device=dev)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    backend = _mesh_backend(captured.getvalue(), 1, 1)
    if backend != "nccl" or res.steps != MESH_RMW_STEPS:
        _fail(f"mesh rmw ran {res.steps} steps on {backend}")
    if launches["scatter_add_rmw"] != 2 * res.steps:
        _fail(f"mesh rmw: launches {launches} in {res.steps} steps (kernel "
              "8 twice a step expected)")
    if not all(math.isfinite(x) for x in res.epoch_losses):
        _fail(f"mesh rmw epoch loss not finite: {res.epoch_losses}")
    if peak > 1.25 * table_bytes:
        _fail(f"mesh rmw peak device memory {peak} > 1.25 x the table's "
              f"{table_bytes} bytes")
    us, wps = _steady(res)
    print(f"[mesh] (c) capacity on the mesh ({backend}, vocab=1): V={V}, "
          f"{res.steps} steps of B={Bc}, loss {res.epoch_losses[-1]:.4f}; "
          f"steady {us:.1f} us/step, {wps:.1f} words/sec (card clock); "
          f"peak device memory {peak} bytes = {peak / table_bytes:.4f} x "
          f"the table; launches {launches}")
    del res
    torch.cuda.empty_cache()

    # (d): the same draws through the one-rank NCCL chunk (R) and
    # LocalMesh vocab = MESH_CAP_NV (M).  A pure vocab split gives every
    # shard the same update rows as R; kernel 8 sums an id's rows in
    # float32 cut at other tile edges and rounds the sum once, so M and R
    # differ where a sum's bf16 rounding flips: held to MESH_CAP_TOL
    n = MESH_CAP_STEPS
    tokens, sents = _epoch(vocab, encoded[:4_000_000], dev, Bc, n, W)
    atab = build_alias_table(vocab.unigram_weights()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Gc = cfg.neg_sharing
    shrinks = torch.randint(0, W, (n, Bc), generator=gen, device=dev)
    negs = draw_negatives(gen, atab, (n, Bc // Gc, K), V)
    scalars = ChunkScalars(base0=W, alpha0=cfg.effective_alpha,
                           wca_start=0.0, wca_per_step=float(Bc),
                           denom=float(vocab.train_words) + 1.0)
    hyper = CBOWHyper(bitlevel=1, size=Dd, window=W, negative=K)
    inputs = (tokens, sents, atab, scalars, shrinks, negs)
    u0, v0 = init_params(V, Dd, dtype=torch.bfloat16, device=dev)
    ru, rv = u0.clone(), v0.clone()
    r_loss = 0.0
    with mesh_session(cfg, dev.type) as comm:
        chunk = make_sharded_chunk(_sharded_slab_body, hyper, comm, V, V, Bc,
                                   1, neg_sharing=Gc, rmw=True)
        for s in range(n):
            sc = scalars._replace(base0=W + s * Bc,
                                  wca_start=s * scalars.wca_per_step)
            ru, rv, part = chunk(comm, ru, rv, tokens, sents, atab, sc,
                                 shrinks=shrinks[s:s + 1],
                                 negs=negs[s:s + 1])
            r_loss += float(part)
    mu, mv, m_loss, m_launches, ms = _local_mesh_chunk(
        dev, 1, MESH_CAP_NV, u0, v0, n, dict(neg_sharing=Gc, rmw=True),
        hyper, V, Bc, inputs, 1)
    del u0, v0
    if m_launches["scatter_add_rmw"] != 2 * n * MESH_CAP_NV:
        _fail(f"mesh vocab={MESH_CAP_NV}: kernel 8 launched "
              f"{m_launches['scatter_add_rmw']} times, not "
              f"{2 * n * MESH_CAP_NV}")
    em = (_errs(mu, ru), _errs(mv, rv), abs(m_loss - r_loss) / abs(r_loss))
    del mu, mv
    torch.cuda.empty_cache()
    print(f"[mesh] (d) LocalMesh vocab={MESH_CAP_NV} at V={V}, D={Dd}: {n} "
          f"steps of B={Bc} in {ms:.1f} ms ({ms / n * 1e3:.1f} us/step, all "
          f"shards); against the vocab=1 chunk: u max {em[0][0]:.6g} rel "
          f"{em[0][1]:.6g}, v max {em[1][0]:.6g} rel {em[1][1]:.6g}, loss "
          f"rel {em[2]:.6g}; tolerance (rel, loss) {MESH_CAP_TOL}; launches "
          f"{m_launches}")
    if (max(em[0][1], em[1][1]) > MESH_CAP_TOL[0]
            or em[2] > MESH_CAP_TOL[1]):
        _fail(f"mesh vocab={MESH_CAP_NV} at capacity: outside its tolerance")
    # kernel 8 on the step-0 lists of vocab shards 0 (the Zipf head) and
    # nv - 1 against the single card's
    slab = chunk_slabs(tokens, sents, W, 1, Bc, W)[0][0].clamp_min(0)
    Vs = -(-V // MESH_CAP_NV)
    times = {}
    for name, ids, tab in (("u", slab, ru),
                           ("v", torch.cat([slab[W:W + Bc],
                                            negs[0].reshape(-1)]), rv)):
        rows = torch.randn((ids.shape[0], Dd), device=dev) * 1e-3
        t = times[name] = dict(
            single_ms=_time_ms(lambda: scatter_add_rmw(tab, ids, rows)),
            slots=int(ids.shape[0]))
        for vi in (0, MESH_CAP_NV - 1):
            loc = to_local(ids, vi, Vs)
            shard = tab[vi * Vs:(vi + 1) * Vs]
            t[f"shard{vi}_ms"] = _time_ms(
                lambda: scatter_add_rmw(shard, loc, rows))
            t[f"shard{vi}_sentinels"] = int((loc >= Vs).sum())
        last = MESH_CAP_NV - 1
        print(f"[mesh] (d) kernel 8, {name} table, step 0 ({t['slots']} "
              f"slots): vocab shard 0 {t['shard0_ms']:.5f} ms "
              f"({t['shard0_sentinels']} sentinels), shard {last} "
              f"{t[f'shard{last}_ms']:.5f} ms ({t[f'shard{last}_sentinels']}"
              f" sentinels); the single card {t['single_ms']:.5f} ms")
    del ru, rv
    torch.cuda.empty_cache()
    return launches, m_launches, dict(us_per_step=us, words_per_sec=wps,
                                      peak_over_table=peak / table_bytes,
                                      local_us_per_step=ms / n * 1e3,
                                      kernel8=times, err=em)


def report_ptxas() -> None:
    """Each kernel's registers, static shared memory and spills as ptxas
    reported them in this run's build; kernels 1, 5 and 9, the banded
    u-sum, the subword gather-mean, the position-weighted context and
    every instantiation of the tile template (kernels 2 and 3,
    every row source; 6, its head-fold epilogue in hot_slice.cu; 7 and 8 in
    group_rmw.cu) must not spill."""
    from word2bits_tpu_torch.kernels._build import (BUILD_LOGS,
                                                    KERNEL_SOURCES,
                                                    ptxas_usage)
    spills = []
    for name in KERNEL_SOURCES:
        usage = ptxas_usage(BUILD_LOGS.get(name, ""))
        if not usage:
            _fail(f"no ptxas report for csrc/{name}.cu")
        for u in usage:
            print(f"[ptxas] {name}.cu {u['function']}: {u['registers']} "
                  f"registers, {u['smem']} bytes static shared memory, "
                  f"spill stores {u['spill_stores']} B, spill loads "
                  f"{u['spill_loads']} B")
            held = (name in ("context", "span_scatter", "sweep_scatter",
                             "score", "band_usum", "subword_mean",
                             "pos_context")
                    or "tile_scatter_kernel" in u["function"])
            if held and (u["spill_stores"] or u["spill_loads"]):
                spills.append(u["function"])
    if spills:
        _fail(f"kernels 1, 2, 3, 5, 6, 7, 8, 9, the banded u-sum, the "
              f"subword gather-mean and the position-weighted context "
              f"must not spill: {spills}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "word2bits_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(word2bits_tpu_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, repo)
    from word2bits_tpu_torch.kernels._build import build_all

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = build_all(fresh=True)
    print(f"[build] {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    report_ptxas()

    ctx200 = check_context(dev, B, D, "context")
    band = check_band_usum(dev)
    sub = check_subword_mean(dev)
    pos = check_pos_context(dev)
    span = check_span(dev)
    span["paths"] = check_span_paths(dev)
    score = check_score(dev)
    check_score_edges(dev)
    rank1 = check_rank1(dev)
    hot = check_hot(dev)
    check_hot_edges(dev)
    check_step_and_chunk(dev)
    grmw = check_grmw(dev)
    grmw["at_widths"] = check_grmw_edges(dev)
    rmw = check_rmw(dev)
    check_rmw_edges(dev)
    ctx = check_context(dev, FLAG_B, FLAG_D, "context@800")
    ctx_exact = check_context(dev, EXACT_B, D, "context@exact",
                              torch.float32)
    # kernels 1 and 7 at [flagship run]'s shapes: the tool's window 5
    # (kernel 1's F = 256 + 2 x 5 window rows) and 10 negatives
    fr = flagship_run_shape()
    ctx_fr = check_context(dev, FLAG_B, FLAG_D, "context@flagship run",
                           w=fr["window"])
    grmw_fr = check_grmw(dev, FLAG_B + 2 * fr["window"],
                         (FLAG_B // fr["neg_sharing"]) * fr["negative"],
                         "grmw@flagship run")
    check_context_masks(dev)
    quant = check_quantize(dev)
    sweep = check_sweep(dev)
    check_sweep_edges(dev)
    check_span_edges(dev)
    print(f"[redesign] kernel 1 at D = 800 {ctx['ms']:.5f} ms (plain "
          f"{ctx['plain_ms']:.5f}), at D = 200 {ctx200['ms']:.5f} ms; kernel 9 "
          f"{sweep['ms']:.5f} ms (index_add_ {sweep['library_ms']:.5f})")
    # kernels 2 and 3 beside the times of their one-CTA-a-run design
    # (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6)
    exact2 = rank1["span_at_exact"]
    for name, now, before, bound, lib in (
            ("kernel 3, exact", rank1["ms"], 0.21589, rank1["bound_ms"],
             rank1["library_ms"]),
            ("kernel 2, exact", exact2["ms"], 0.2327, exact2["bound_ms"],
             exact2["library_ms"]),
            ("kernel 2, shipped", span["ms"], 0.02822, span["bound_ms"],
             span["library_ms"])):
        print(f"[redesign] {name}: {now:.5f} ms (one CTA a run: "
              f"{before:.5f}), bound {bound:.5f}, index_add_ {lib:.5f}")
    # kernels 5 and 7 beside the times of their earlier designs (one CTA a
    # tile; one CTA a visit), NVIDIA H100 80GB HBM3, 700 W, PERF.md section 6
    print(f"[redesign] kernel 5: {score['ms']:.5f} ms (one CTA a tile: "
          f"0.06411), bound {score['bound_ms']:.5f}, the three bmm "
          f"{score['bmm_only_ms']:.5f}")
    print(f"[redesign] kernel 7: {grmw['ms']:.5f} ms (one CTA a visit: "
          f"0.24240), bound {grmw['bound_ms']:.5f}, index_add_ "
          f"{grmw['library_ms']:.5f}")
    # kernels 6 and 8 beside the times of their earlier designs (one CTA a
    # head row; one CTA a visit), NVIDIA H100 80GB HBM3, 700 W, PERF.md
    # section 6
    print(f"[redesign] kernel 6: {hot['ms']:.5f} ms (one CTA a head row: "
          f"0.00896), bound {hot['bound_ms']:.5f}, index_add_ "
          f"{hot['library_ms']:.5f}; with extra "
          f"{hot['stratified_extra_ms']:.5f}, bound "
          f"{hot['stratified_extra_bound_ms']:.5f}, index_add_ "
          f"{hot['stratified_extra_library_ms']:.5f}")
    print(f"[redesign] kernel 8: {rmw['ms']:.5f} ms for one step's two calls "
          f"(one CTA a visit: 0.26565), bound {rmw['bound_ms']:.5f}, "
          f"index_add_ {rmw['library_ms']:.5f}")
    work = os.path.join(repo, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    by_path = {}
    try:
        by_path["train"], vec_path, corpus = train_main_path(work)
        by_path["mesh"], mesh = run_mesh_train(work, corpus)
        by_path["flagship"], pack, flag_corpus, ckdir = train_flagship(
            work, dev)
        check_accuracy(dev, pack, ACC_THRESHOLD, ACC_QUESTIONS,
                       "flagship.pack")
        by_path["resume"] = run_resume(dev, *flag_corpus, ckdir)
        shutil.rmtree(ckdir)
        by_path["rmw"] = run_rmw(dev, *flag_corpus)
        (by_path["mesh rmw"], by_path[f"mesh rmw vocab={MESH_CAP_NV}"],
         mesh["capacity"]) = run_mesh_capacity(dev, *flag_corpus)
        check_native(corpus, flag_corpus[0])
        check_device_epoch(dev, *flag_corpus, FLAG_B, 32, "flagship")
        del flag_corpus
        by_path["flagship run"] = run_flagship_tool(work)
        check_accuracy(dev, vec_path, 0, 2000, "train.bin")
        by_path["quickstart"], prepared = train_quickstart(work, corpus, dev)
        by_path.update(check_determinism(work, dev, *prepared))
        mesh["local"] = check_local_mesh(dev, *prepared)
        for tag, launches in mesh["local"].pop("launches").items():
            by_path[f"mesh {tag}"] = launches
        check_device_epoch(dev, *prepared, B, S, "train")
        by_path["exact"], _ = run_exact(dev, *prepared)
        by_path["sweep"] = run_sweep(dev, *prepared)
        by_path.update(run_pallas(dev, *prepared))
        by_path.update(run_hot(work, dev, *prepared))
        check_skipgram_step(dev)
        by_path.update(run_skipgram(work, dev, *prepared))
        by_path["tune"] = run_tune(corpus)
        by_path["profile"] = run_profile(work, dev, *prepared)
        by_path.update(run_parity(dev))
        by_path.update(run_convert_nearest(work))
        by_path["fasttext"] = run_fasttext(work, dev)
        by_path["ftcbow"] = run_ftcbow(work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    at = ("max_abs_err", "ms", "plain_ms", "bound_ms", "shapes")
    by_id = ("rows_ms", "gather_ms")
    ctx["at_d200"] = {k: ctx200[k] for k in at + by_id}
    ctx["at_exact"] = {k: ctx_exact[k] for k in at + by_id}
    ctx["at_flagship_run"] = {k: ctx_fr[k] for k in at + by_id}
    grmw["at_flagship_run"] = {k: grmw_fr[k] for k in at + ("library_ms",)}
    span["at_exact"] = rank1.pop("span_at_exact")
    span["mesh"] = {t: m["kernel2"] for t, m in mesh["local"].items()
                    if "kernel2" in m}
    rmw["mesh"] = {f"vocab={MESH_CAP_NV}": mesh["capacity"]["kernel8"]}
    kernels = [ctx, span, rank1, score, hot, grmw, rmw, quant, sweep, band,
               sub, pos]
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shapes",
            "launches_by_path", "at_d200", "at_exact", "at_flagship_run",
            "bmm_only_ms", "parts_ms", "parts_dense_ms",
            "span_materialized_ms", "span_materialized_with_forming_ms",
            "config", "at_widths",
            "plan_ms", "stratified_extra_ms", "stratified_extra_bound_ms",
            "stratified_extra_library_ms", "bf16", "whole_ms",
            "whole_bound_ms", "export_blocks_ms", "export_blocks_plain_ms",
            "mesh", "paths", "forward_ms", "backward_ms",
            "plain_forward_ms", "plain_backward_ms")
    print(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys if k in kd}
                                  for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
