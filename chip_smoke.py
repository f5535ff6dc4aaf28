"""Smoke run of word2bits_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from
word2bits_tpu_torch/csrc/ (one nvcc per source, all at once; [ptxas]
prints each kernel's registers, shared memory and spills, and kernels 1
and 9 must not spill), holds each against its plain PyTorch version at
the shapes of the paths that run it ([context], [span], [score], [rank1]
with kernel 2 on its float32 table, [hotk], [grmw], [rmwk],
[context@800], [context@exact] on float32 rows, [context@mask] on
non-banded random masks, [quantk] kernel 4 at the capacity export's
block, on a bf16 table and on the whole 3.7M x 800 sum, [sweepk] kernel
9 at kernel 2's shape and [sweepk edges] on a plan whose head id spans
four blocks), checks
the steps and chunks of both engines on the card against the same code on
the CPU ([step], the fused chunk's "sweep" scatter among them), and then
drives the port's paths through their entry points, each with the
kernels' launch counts set to 0 just before and read just after:

  [train]       the shipped throughput configuration (the JAX package's
                bench.py CFG plus ctx_span_banded256_S256: size 200, span
                scatter) through `cli train`, one epoch of a 17M-token
                corpus;
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
  [rmw]         the capacity configuration with `-rmw-scatter 1
                -steps-per-chunk 1` (docs/large_vocab.md:34), 16 steps,
                kernel 8 twice a step, peak device memory against the table;
  [sweep]       one 256-step fused chunk at the shipped flags with
                scatter_impl="sweep" (kernel 9; the config rejects the
                flag, as the JAX package's does), against the same chunk
                with "span";
  [convert]     `cli convert` of a seeded 70,000 x 200 float32 file at
                three flag sets, card against W2B_FORCE_CPU=1, the files
                byte-identical; [nearest] `cli nearest` of 20 words at
                bitlevels 1 and 0, the transcripts equal apart from ties.

Peak disk is about 24 GB, in [flagship]: the 11.84 GB checkpoint, the
11.9 GB vector file and the 0.4 GB `.pack` (all in .smoke_work/, removed
at the end).

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


# ---------------------------------------------------------------- kernel 1
def _hold_context(args, b: int, tag: str, bitlevels=(0, 1, 2, 4, 8)) -> float:
    """fused_context_pallas against fused_context_plain on `args` at each
    bitlevel; the worst output error over the compared centers.

    Both compute each center's score f = cavg . quantize(v_center) in
    float32 in another order, and three functions of f are discontinuous:
    the LUT sigmoid at its bin edges ((f+6)*83 an integer) and
    sigmoid_exact at +-6.  A center whose plain f lies within 0.005 of a LUT
    bin edge (6e-5 in f) or within 6e-5 of +-6 may take the other side in
    the kernel, so its outputs are not compared (there may be at most 5% of
    them: about 1% of continuous scores lie that close to a bin edge) and
    the loss may move by the jump of log(sigmoid_exact) at the edge for
    each such center at +-6.  The edges are found from the plain version's
    f alone.  Everything else: outputs atol 1e-4 + rtol 1e-4, loss rtol
    1e-5."""
    from word2bits_tpu_torch.kernels.context_pallas import (
        fused_context_pallas, fused_context_plain)
    from word2bits_tpu_torch.ops.quantize import quantize
    uwin3, vc, Mb, validf, alpha = args
    worst = 0.0
    for bl in bitlevels:
        got = fused_context_pallas(uwin3, vc, Mb, validf, alpha, bl)
        want = fused_context_plain(uwin3, vc, Mb, validf, alpha, bl)
        torch.cuda.synchronize()
        f = (want[0] * quantize(vc.float(), bl)).sum(dim=1)
        x = (f + 6.0) * 83.0
        lut_edge = ((x - x.round()).abs() < 0.005) & (f.abs() <= 6.0)
        lo, hi = (f + 6.0).abs() < 6e-5, (f - 6.0).abs() < 6e-5
        edge = lut_edge | lo | hi
        n_edge = int(edge.sum())
        if n_edge > 0.05 * b:
            _fail(f"[{tag}] context kernel at bitlevel {bl}: {n_edge} centers "
                  "at a score edge (more than 5%)")
        keep = ~edge
        errs = []
        for name, g, w in zip(("cavg", "cavge", "dv_center", "af"), got,
                              want):
            g, w = g[keep], w[keep]
            if not torch.allclose(g, w, atol=1e-4, rtol=1e-4):
                _fail(f"[{tag}] context kernel {name} at bitlevel {bl}: max "
                      f"abs err {_max_err(g, w):.3e} > atol 1e-4 + rtol 1e-4")
            errs.append(_max_err(g, w))
        worst = max(worst, *errs)
        lg, lw = float(got[4]), float(want[4])
        allow = (1e-5 * abs(lw) + _JUMP_LO * int(lo.sum())
                 + _JUMP_HI * int(hi.sum()))
        if not math.isfinite(lg) or abs(lg - lw) > allow:
            _fail(f"[{tag}] context kernel loss at bitlevel {bl}: {lg} vs "
                  f"{lw} (allowed {allow:.4g})")
        print(f"[{tag}] bitlevel {bl}: max abs err {max(errs):.3e} over "
              f"{b - n_edge} centers ({n_edge} at a score edge, "
              f"{int(lo.sum() + hi.sum())} of them at +-6), loss "
              f"{lg:.6f} vs plain {lw:.6f}")
    return worst


def _context_inputs(dev, b: int, d: int, dtype: torch.dtype, mask: str):
    """Kernel 1's inputs at B = b, D = d, W = 8, tile 256: a seeded slab,
    sentences of ~20 tokens (a few padding positions at the end), and the
    banded masks of random shrinks; or, with mask="random", a non-banded
    0/1 mask with ~30% ones over all F = 272 columns and every 37th row
    empty, whose span is wider than one staged piece."""
    from word2bits_tpu_torch.ops.windowed import (_tile_windows,
                                                  build_banded_masks)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Nt = b // TILE
    slab = (torch.randn((b + 2 * W, 2 * d), generator=gen, device=dev)
            * 0.3).to(dtype)
    sents = torch.arange(b + 2 * W, device=dev) // 20
    sents[-5:] = -1
    shrink = torch.randint(0, W, (b,), generator=gen, device=dev)
    Mb, _, valid = build_banded_masks(sents, shrink, b, W, TILE)
    if mask == "random":
        Mb = (torch.rand(Mb.shape, generator=gen, device=dev) < 0.3).to(
            torch.float32)
        Mb.view(b, -1)[::37] = 0.0
    uwin3 = _tile_windows(slab[:, :d], Nt, TILE, W).contiguous()
    vc = slab[W:W + b, d:].contiguous()
    validf = valid.to(torch.float32)[:, None].contiguous()
    alpha = torch.full((1, 1), 0.1, device=dev)
    return uwin3, vc, Mb, validf, alpha


def context_launch_shape(b: int, d: int, dtype: torch.dtype) -> str:
    """Kernel 1's launch at B = b, D = d, W = 8, tile 256 (its C report)."""
    import ctypes
    from word2bits_tpu_torch.kernels.context_pallas import _library
    out = (ctypes.c_int * 4)()
    fn = _library().w2b_context_launch_shape
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    F = TILE + 2 * W
    if fn(F, d, TILE, 1 if dtype == torch.bfloat16 else 0,
          ctypes.addressof(out)):
        _fail(f"kernel 1 refuses D = {d}")
    grid = (TILE // 16) * (b // TILE)
    return (f"{grid} CTAs of {out[0]} threads, {out[1]} bytes of dynamic "
            f"shared memory, {out[2]} window rows a piece, {out[3]} centers "
            "a thread")


def check_context(dev, b: int, d: int, tag: str,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """fused_context_pallas against fused_context_plain on the card at
    B = b, D = d, W = 8, tile 256, bitlevels 0/1/2/4/8, table rows of
    `dtype` (bf16 on the fused engines, float32 on the split tables), with
    the edge rule of _hold_context; then both timed at bitlevel 1."""
    from word2bits_tpu_torch.kernels.context_pallas import (
        fused_context_pallas, fused_context_plain)
    args = _context_inputs(dev, b, d, dtype, "banded")
    print(f"[{tag}] launch: {context_launch_shape(b, d, dtype)}")
    worst = _hold_context(args, b, tag)
    uwin3, vc, Mb, validf, alpha = args
    args = (uwin3, vc, Mb, validf, alpha, 1)
    ms = _time_ms(lambda: fused_context_pallas(*args))
    plain_ms = _time_ms(lambda: fused_context_plain(*args))
    # bytes: each input read once, each output written once
    nbytes = sum(t.numel() * t.element_size()
                 for t in (uwin3, vc, Mb, validf, alpha))
    nbytes += 3 * b * d * 4 + b * 4 + 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] bitlevel 1 kernel {ms:.5f} ms, plain {plain_ms:.5f} "
          f"ms, bound {bound_ms:.5f} ms ({nbytes} bytes)")
    return dict(name="fused_context_pallas", route="cuda",
                source="word2bits_tpu_torch/csrc/context.cu",
                replaces="word2bits_tpu/kernels/context_pallas.py:82",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                shapes=f"B={b}, D={d}, W={W}, tile {TILE}, "
                       f"{str(dtype).removeprefix('torch.')} rows")


def check_context_masks(dev) -> float:
    """Kernel 1 on non-banded random 0/1 masks (~30% ones, every 37th row
    empty, a span of F = 272 rows against one piece of 32): B = 4096,
    D = 200 in bf16 and float32 rows, and D = 37 in float32 (the scalar
    path: no 16-byte access fits that width); same edge rule and
    tolerances as the banded checks."""
    worst = 0.0
    for b, d, dtype in ((4096, D, torch.bfloat16), (4096, D, torch.float32),
                        (1024, 37, torch.float32)):
        tag = f"context@mask D={d} {str(dtype).removeprefix('torch.')}"
        args = _context_inputs(dev, b, d, dtype, "random")
        print(f"[{tag}] {int(args[2].sum())} ones of {args[2].numel()}")
        worst = max(worst, _hold_context(args, b, tag))
    return worst


# ---------------------------------------------------------------- kernel 2
def check_span(dev) -> dict:
    """The span scatter kernel against scatter_add_span_plain on the card:
    a bf16 [70000, 400] table, Zipf ids with duplicates plus drop
    sentinels, float32 rows.  Both sum each id's bf16-rounded rows in
    float32 and round once into the table, in another order, so they agree
    to one bf16 rounding: atol 1e-5 + rtol 2^-7."""
    from word2bits_tpu_torch.kernels.span_scatter import (
        scatter_add_span_plain, scatter_add_span_planned, span_plan)
    rng = np.random.default_rng(SEED)
    V, C, N = SCATTER_V, 2 * D, SCATTER_N
    ids = torch.from_numpy(_step_ids(rng, V, B + 2 * W, N - B - 2 * W,
                                     64)).to(dev)
    rows = (torch.randn((N, C), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 0.01)
    table0 = (torch.rand((V, C), generator=torch.Generator(
        device=dev).manual_seed(SEED + 1), device=dev) - 0.5).to(
        torch.bfloat16)
    plan = span_plan(ids, V)
    got = scatter_add_span_planned(table0.clone(), plan, rows)
    want = scatter_add_span_plain(table0.clone(), ids, rows)
    torch.cuda.synchronize()
    err = _max_err(got, want)
    if not torch.allclose(got.float(), want.float(), atol=1e-5,
                          rtol=2 ** -7):
        _fail(f"span scatter: max abs err {err:.3e} > atol 1e-5 + "
              "rtol 2^-7")
    if torch.equal(got, table0):
        _fail("span scatter changed nothing")
    n_unique = int(plan.n_runs)
    longest = int((plan.run_start[1:n_unique + 1]
                   - plan.run_start[:n_unique]).max())
    print(f"[span] max abs err {err:.3e}; {N} rows, {n_unique} distinct "
          f"ids, longest run {longest}")
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
    return dict(name="scatter_add_span", route="cuda",
                source="word2bits_tpu_torch/csrc/span_scatter.cu",
                replaces="word2bits_tpu/kernels/span_scatter.py:200",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                shapes=f"table [{V}, {C}] bf16, {N} f32 rows")


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
        quantized_scores_pallas, quantized_scores_plain)
    from word2bits_tpu_torch.ops.quantize import quantize
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    T, PK = SCORE_T, SCORE_PK
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
            want = quantized_scores_plain(*args)
            torch.cuda.synchronize()
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
                  f"{lg:.6f} vs plain {lw:.6f}")
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
                library_ms=None, bmm_only_ms=bmm_ms,
                shapes=f"T={T}, G={G}, P*K={PK}, D={D}, f32")


# ---------------------------------------------------------------- kernel 3
def check_rank1(dev) -> dict:
    """scatter_add_span_rank1 against its plain version at the exact-mode
    shape: a float32 [69,998, 200] table, 4,096 dense center rows and
    4,096 * 24 rank-1 rows g[j] * cavg[j // 24], the ids drawn like one
    step (subsampled Zipf(1.05) centers, unigram^0.75 negatives).  Both sum
    each id's rows in float32 in another order: atol 1e-5 + rtol 1e-5.
    Kernel 2 on the same rows materialized (the exact mode's float32 v
    scatter) is held to the same tolerance against its plain version and
    the rank-1 plain version, and timed beside it, with and without
    forming the rows; so is index_add_ of the materialized rows."""
    from word2bits_tpu_torch.kernels.span_scatter import (
        scatter_add_span_plain, scatter_add_span_planned,
        scatter_add_span_rank1, scatter_add_span_rank1_plain, span_plan)
    rng = np.random.default_rng(SEED + 3)
    V, nd = RANK1_V, RANK1_ND
    nn = nd * K
    ids = torch.from_numpy(_step_ids(rng, V, nd, nn, 0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    dense = torch.randn((nd, D), generator=gen, device=dev) * 0.01
    g = torch.randn((nn,), generator=gen, device=dev) * 0.01
    cavg = torch.randn((nd, D), generator=gen, device=dev) * 0.1
    table0 = torch.rand((V, D), generator=gen, device=dev) - 0.5
    plan = span_plan(ids, V)
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
    n_unique = int(plan.n_runs)
    print(f"[rank1] max abs err {err:.3e} against the plain version; "
          f"kernel 2 on the materialized rows {mat_err:.3e} against the "
          f"plain versions, {_max_err(got, mat):.3e} against kernel 3; "
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


# ---------------------------------------------------------------- kernel 7
def check_grmw(dev) -> dict:
    """The group-RMW kernel against its plain version at the flagship:
    two copies of one random bf16 [3,699,941, 1,600] table, one step's
    22,544 float32 rows (subsampled Zipf(1.05) slab ids, unigram^0.75
    negatives, 64 drop sentinels).  Touched rows: atol 1e-5 + rtol 2^-7
    (each id's bf16-rounded rows summed in float32 in another order, one
    rounding into the table); every other row must be untouched in both."""
    from word2bits_tpu_torch.kernels.group_rmw import (
        group_plan, group_rows, scatter_add_grmw_plain,
        scatter_add_grmw_planned)
    rng = np.random.default_rng(SEED + 7)
    V, C, N = FLAG_V, 2 * FLAG_D, FLAG_N
    n_slab = FLAG_B + 2 * W
    ids = torch.from_numpy(_step_ids(rng, V, n_slab, N - n_slab, 64)).to(dev)
    rows = (torch.randn((N, C), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 0.01)
    got = torch.empty((V, C), dtype=torch.bfloat16, device=dev)
    got.uniform_(-0.5, 0.5, generator=torch.Generator(
        device=dev).manual_seed(SEED + 1))
    want = got.clone()
    plan = group_plan(ids, group_rows(got.dtype))
    scatter_add_grmw_planned(got, plan, rows)
    scatter_add_grmw_plain(want, ids, rows)
    torch.cuda.synchronize()
    touched = torch.unique(ids[ids < V])
    g, w = got[touched].float(), want[touched].float()
    err = _max_err(g, w)
    if not torch.allclose(g, w, atol=1e-5, rtol=2 ** -7):
        _fail(f"grmw: max abs err {err:.3e} on the touched rows > atol "
              "1e-5 + rtol 2^-7")
    untouched = torch.ones(V, dtype=torch.bool, device=dev)
    untouched[touched] = False
    step = 1 << 18
    for r0 in range(0, V, step):
        m = untouched[r0:r0 + step]
        if not torch.equal(got[r0:r0 + step][m], want[r0:r0 + step][m]):
            _fail(f"grmw wrote rows it was not given (rows {r0}..)")
    n_vis = int(plan.n_vis)
    vr, rs = plan.vis_run.long(), plan.run_start.long()
    vis_rows = rs[vr[1:n_vis + 1]] - rs[vr[:n_vis]]
    n_groups = int(torch.unique(touched >> 4).numel())
    print(f"[grmw] max abs err {err:.3e}; {N} rows, {touched.numel()} "
          f"distinct ids in {n_groups} groups, {n_vis} visits, longest "
          f"visit {int(vis_rows.max())} rows")
    ms = _time_ms(lambda: scatter_add_grmw_planned(got, plan, rows))
    plain_ms = _time_ms(lambda: scatter_add_grmw_plain(want, ids, rows))
    keep = ids < V
    ids_in, rows_in = ids[keep], rows[keep].to(torch.bfloat16)
    library_ms = _time_ms(lambda: got.index_add_(0, ids_in, rows_in))
    # bytes: rows and plan read once; each touched row read and written
    nbytes = (rows.numel() * 4 + sum(t.numel() * 4 for t in plan)
              + 2 * touched.numel() * C * 2)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[grmw] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    del got, want
    torch.cuda.empty_cache()
    return dict(name="scatter_add_grmw", route="cuda",
                source="word2bits_tpu_torch/csrc/group_rmw.cu",
                replaces="word2bits_tpu/kernels/group_rmw.py:184",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                shapes=f"table [{V}, {C}] bf16, {N} f32 rows")


# ---------------------------------------------------------------- kernel 6
def check_hot(dev) -> dict:
    """Kernel 6 against its plain version at the [hot] path: a bf16
    [70,000, 400] table, H = 2048, one step's 8,208 float32 slab rows
    (subsampled Zipf(1.05) ids; no extra), and the -neg-stratify step's
    (the slab rows plus T*P*kh hot lanes, with the dense float32 `extra`).
    Both round the rows to bf16, sum each head row's rows in float32 in
    another order and round once, after the same head + extra rounding:
    atol 1e-5 + rtol 2^-7 (one bf16 rounding); every row past the head
    must be untouched."""
    from word2bits_tpu_torch.kernels.hot_pallas import (
        hot_plan, hot_slice_add_pallas, hot_slice_add_plain)
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
        want = hot_slice_add_plain(table0.clone(), ids, rows, H, extra)
        torch.cuda.synchronize()
        err = _max_err(got[:H], want[:H])
        if not torch.allclose(got[:H].float(), want[:H].float(), atol=1e-5,
                              rtol=2 ** -7):
            _fail(f"hot kernel ({tag}): max abs err {err:.3e} > atol 1e-5 + "
                  "rtol 2^-7")
        if not torch.equal(got[H:], table0[H:]):
            _fail(f"hot kernel ({tag}) wrote rows past the head")
        n_hot = int(((ids >= 0) & (ids < H)).sum())
        print(f"[hotk] {tag}: max abs err {err:.3e}; {ids.numel()} rows, "
              f"{n_hot} of them hot, into a [{H}, {C}] head")
        worst = max(worst, err)
        cases[tag] = (ids, rows, extra, n_hot)
    # timed as the chunk calls it: the plan hoisted (its time apart)
    ids, rows, _, n_hot = cases["hot"]
    plan = hot_plan(ids, H)
    scratch = table0.clone()
    ms = _time_ms(lambda: hot_slice_add_pallas(scratch, ids, rows, H,
                                               plan=plan))
    plan_ms = _time_ms(lambda: hot_plan(ids, H))
    plain_ms = _time_ms(lambda: hot_slice_add_plain(scratch, ids, rows, H))
    keep = ids < H
    ids_in, rows_in = ids[keep], rows[keep].to(torch.bfloat16)
    library_ms = _time_ms(lambda: scratch.index_add_(0, ids_in, rows_in))
    # bytes: the ids and the hot rows read once, the head read and
    # written once
    nbytes = ids.numel() * 8 + n_hot * C * 4 + 2 * H * C * 2
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ids_s, rows_s, extra_s, n_hot_s = cases["stratified, extra"]
    plan_s = hot_plan(ids_s, H)
    strat_ms = _time_ms(lambda: hot_slice_add_pallas(scratch, ids_s, rows_s,
                                                     H, extra_s, plan=plan_s))
    strat_bytes = (ids_s.numel() * 8 + n_hot_s * C * 4 + 2 * H * C * 2
                   + H * C * 4)
    print(f"[hotk] kernel {ms:.4f} ms (one step's plan, hoisted to the "
          f"chunk's entry, {plan_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, index_add_ of the hot rows "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes); "
          f"stratified with extra {strat_ms:.4f} ms (bound "
          f"{strat_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return dict(name="hot_slice_add_pallas", route="cuda",
                source="word2bits_tpu_torch/csrc/hot_slice.cu",
                replaces="word2bits_tpu/kernels/hot_pallas.py:84",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                plan_ms=plan_ms, stratified_extra_ms=strat_ms,
                shapes=f"table [{V}, {C}] bf16, H={H}, {ids.numel()} f32 "
                       f"rows ({n_hot} hot)")


# ---------------------------------------------------------------- kernel 8
def check_rmw(dev) -> dict:
    """Kernel 8 against its plain version at the capacity shape: two
    copies of one random bf16 [3,699,941, 1,600] table, one step's two
    calls (16,400 float32 slab rows of subsampled Zipf(1.05) ids, then
    6,144 negative rows of unigram^0.75 ids, 64 drop sentinels each).
    Both sum each id's bf16-rounded rows in float32 in another order,
    round the sum, and add it with one rounding, twice: a touched value may
    differ by two bf16 roundings of itself and of the sums that entered it
    (|got - want| <= 2^-6 (|want| + A) + 1e-6, A the per-id sum of |rows|);
    every other row must be untouched in both."""
    from word2bits_tpu_torch.kernels.group_rmw import group_plan
    from word2bits_tpu_torch.kernels.scatter_pallas import (
        group_rows, scatter_add_rmw, scatter_add_rmw_plain,
        scatter_add_rmw_planned)
    from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
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
    for ids, rows in calls:
        scatter_add_rmw(got, ids, rows)
        scatter_add_rmw_plain(want, ids, rows)
    torch.cuda.synchronize()
    all_ids = torch.cat([c[0] for c in calls])
    keep = all_ids < V
    touched, slot = torch.unique(all_ids[keep], return_inverse=True)
    mags = torch.zeros((touched.numel(), C), device=dev)
    mags.index_add_(0, slot, torch.cat([c[1] for c in calls])[keep].abs())
    g, w = got[touched].float(), want[touched].float()
    err = _max_err(g, w)
    allowed = 2 ** -6 * (w.abs() + mags) + 1e-6
    if not bool(((g - w).abs() <= allowed).all()):
        _fail(f"rmw: max abs err {err:.3e} on the touched rows beyond two "
              "bf16 roundings")
    untouched = torch.ones(V, dtype=torch.bool, device=dev)
    untouched[touched] = False
    step = 1 << 18
    for r0 in range(0, V, step):
        m = untouched[r0:r0 + step]
        if not torch.equal(got[r0:r0 + step][m], want[r0:r0 + step][m]):
            _fail(f"rmw wrote rows it was not given (rows {r0}..)")
    grp = group_rows(got.dtype)
    plans = [group_plan(ids, grp) for ids, _ in calls]
    n_touch = [int(torch.unique(ids[ids < V]).numel()) for ids, _ in calls]
    print(f"[rmwk] max abs err {err:.3e}; calls of {n_slab} and {n_neg} "
          f"rows, {n_touch[0]} and {n_touch[1]} distinct ids "
          f"({touched.numel()} over both), visits "
          f"{[int(pl.n_vis) for pl in plans]}")

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
    plan_ms = _time_ms(lambda: [group_plan(ids, grp) for ids, _ in calls])
    plain_ms = _time_ms(plain)
    library_ms = _time_ms(library)
    # bytes, both calls: rows and plan read once; each touched row read
    # and written once per call
    nbytes = sum(rows.numel() * 4 + sum(t.numel() * 4 for t in pl)
                 + 2 * nt * C * 2
                 for (_, rows), pl, nt in zip(calls, plans, n_touch))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[rmwk] one step's two calls: kernel {ms:.4f} ms (the two plans "
          f"{plan_ms:.4f} ms), plain {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    del got, want
    torch.cuda.empty_cache()
    return dict(name="scatter_add_rmw", route="cuda",
                source="word2bits_tpu_torch/csrc/group_rmw.cu",
                replaces="word2bits_tpu/kernels/scatter_pallas.py:178",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                plan_ms=plan_ms,
                shapes=f"table [{V}, {C}] bf16, {n_slab} + {n_neg} f32 "
                       "rows (one step's two calls)")


# ---------------------------------------------------------------- kernel 4
def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float32 or bfloat16 tensor (-0.0 is not +0.0)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


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
def check_step_and_chunk(dev) -> None:
    """One step and a 3-step chunk of each engine on the card (kernels)
    against the same calls on the CPU (plain versions), at a small shape
    with injected draws, float32 tables: atol 1e-4 + rtol 1e-4, loss rtol
    1e-5.  Configurations: the fused table with the span scatter, with the
    sweep scatter (kernel 9) and with grmw under -loop-mode fori (context
    kernel); the split tables at the
    Quick start (per-center, shifted sums, add) and in the exact mode with
    materialized and with rank-1 negative rows (span, banded, context
    kernel); the score kernel on split and on fused tables; the hot/cold
    split (with and without kernel 6, and with the score kernel), the
    stratified lanes, the dense hot stratum with and without a cold map;
    the RMW scatter (kernel 8); the block dedup on both engines."""
    from word2bits_tpu_torch.data.pipeline import cold_positions
    from word2bits_tpu_torch.models import cbow_fused as cf
    from word2bits_tpu_torch.models import cbow_slab as cs
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                      build_stratified_tables)
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
        ("span (scan)", True, g, "plain", False,
         dict(fused_kw, scatter_impl="span")),
        ("sweep (scan)", True, g, "plain", False,
         dict(fused_kw, scatter_impl="sweep")),
        ("grmw (fori)", True, g, "plain", False,
         dict(fused_kw, scatter_impl="grmw", loop_mode="fori")),
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
        outs = {}
        for where in ("cpu", dev):
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
            data = (tokens.to(where), sents.to(where), atab, sc)
            draws = dict(shrinks=shrinks.to(where), negs=negs.to(where))
            step_kw = {x: y for x, y in kw.items() if x != "loop_mode"}
            if with_map:
                step_kw["cold_pos"] = cold[0].to(where)
                draws["cold_pos"] = cold.to(where)
            if kind == "dense":
                step_kw["dense_hot"] = (dense[1], torch.from_numpy(
                    dense[2]).to(where))
            if fused:
                t0 = torch.cat([u0, v0], dim=1).to(where)
                tab, loss = cf.fused_slab_step(t0.clone(), st_in, alpha,
                                               hyper, b, gg, **step_kw)
                chunk = cf.make_fused_train_chunk(hyper, v, b, s, gg, **kw)
                ctab, closs = chunk(t0.clone(), *data, **draws)
                step, chunked = (tab,), (ctab,)
            else:
                su, sv, loss = cs.slab_step(u0.clone().to(where),
                                            v0.clone().to(where), st_in,
                                            alpha, hyper, b, gg, **step_kw)
                chunk = cs.make_slab_train_chunk(hyper, v, b, s, gg, **kw)
                cu, cv, closs = chunk(u0.clone().to(where),
                                      v0.clone().to(where), *data, **draws)
                step, chunked = (su, sv), (cu, cv)
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

    class _Tee(io.TextIOBase):
        def __init__(self, *streams):
            self.streams = streams

        def write(self, s):
            for st in self.streams:
                st.write(s)
            return len(s)

        def flush(self):
            for st in self.streams:
                st.flush()

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
    for name in ("fused_context_pallas", "scatter_add_span"):
        if launches[name] <= 0:
            _fail(f"{name} was not launched on the main path")
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
    for name in ("fused_context_pallas", "scatter_add_grmw"):
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
    for name in ("fused_context_pallas", "scatter_add_grmw"):
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
            or launches["fused_context_pallas"] != res.steps):
        _fail(f"rmw: launches {launches} in {res.steps} steps (kernel 8 "
              "twice and kernel 1 once per step expected)")
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
    from word2bits_tpu_torch.kernels.context_pallas import \
        fused_context_pallas
    from word2bits_tpu_torch.kernels.group_rmw import \
        scatter_add_grmw_planned
    from word2bits_tpu_torch.kernels.hot_pallas import hot_slice_add_pallas
    from word2bits_tpu_torch.kernels.quantize_pallas import quantize_pallas
    from word2bits_tpu_torch.kernels.scatter_pallas import scatter_add_rmw
    from word2bits_tpu_torch.kernels.score_pallas import \
        quantized_scores_pallas
    from word2bits_tpu_torch.kernels.span_scatter import (
        scatter_add_span_planned, scatter_add_span_rank1)
    from word2bits_tpu_torch.kernels.sweep_scatter import \
        scatter_add_sweep_planned
    return {"fused_context_pallas": fused_context_pallas,
            "scatter_add_span": scatter_add_span_planned,
            "scatter_add_span_rank1": scatter_add_span_rank1,
            "quantized_scores_pallas": quantized_scores_pallas,
            "hot_slice_add_pallas": hot_slice_add_pallas,
            "scatter_add_grmw": scatter_add_grmw_planned,
            "scatter_add_rmw": scatter_add_rmw,
            "quantize_pallas": quantize_pallas,
            "scatter_add_sweep": scatter_add_sweep_planned}


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
                or launches["fused_context_pallas"] != steps):
            _fail(f"{tag}: launches {launches} in {steps} steps (kernel 6 "
                  f"{per_step} and kernel 1 once per step expected)")
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


def report_ptxas() -> None:
    """Each kernel's registers, static shared memory and spills as ptxas
    reported them in this run's build; kernels 1 and 9 must not spill."""
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
            if (name in ("context", "sweep_scatter")
                    and (u["spill_stores"] or u["spill_loads"])):
                spills.append(u["function"])
    if spills:
        _fail(f"kernels 1 and 9 must not spill: {spills}")


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
    span = check_span(dev)
    score = check_score(dev)
    rank1 = check_rank1(dev)
    hot = check_hot(dev)
    check_step_and_chunk(dev)
    grmw = check_grmw(dev)
    rmw = check_rmw(dev)
    ctx = check_context(dev, FLAG_B, FLAG_D, "context@800")
    ctx_exact = check_context(dev, EXACT_B, D, "context@exact",
                              torch.float32)
    check_context_masks(dev)
    quant = check_quantize(dev)
    sweep = check_sweep(dev)
    check_sweep_edges(dev)
    print(f"[redesign] kernel 1 at D = 800 {ctx['ms']:.5f} ms (plain "
          f"{ctx['plain_ms']:.5f}), at D = 200 {ctx200['ms']:.5f} ms; kernel 9 "
          f"{sweep['ms']:.5f} ms (index_add_ {sweep['library_ms']:.5f})")
    work = os.path.join(repo, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    by_path = {}
    try:
        by_path["train"], vec_path, corpus = train_main_path(work)
        by_path["flagship"], pack, flag_corpus, ckdir = train_flagship(
            work, dev)
        check_accuracy(dev, pack, ACC_THRESHOLD, ACC_QUESTIONS,
                       "flagship.pack")
        by_path["resume"] = run_resume(dev, *flag_corpus, ckdir)
        shutil.rmtree(ckdir)
        by_path["rmw"] = run_rmw(dev, *flag_corpus)
        del flag_corpus
        check_accuracy(dev, vec_path, 0, 2000, "train.bin")
        by_path["quickstart"], prepared = train_quickstart(work, corpus, dev)
        by_path["exact"], _ = run_exact(dev, *prepared)
        by_path["sweep"] = run_sweep(dev, *prepared)
        by_path.update(run_pallas(dev, *prepared))
        by_path.update(run_hot(work, dev, *prepared))
        by_path.update(run_convert_nearest(work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    at = ("max_abs_err", "ms", "plain_ms", "bound_ms", "shapes")
    ctx["at_d200"] = {k: ctx200[k] for k in at}
    ctx["at_exact"] = {k: ctx_exact[k] for k in at}
    span["at_exact"] = rank1.pop("span_at_exact")
    kernels = [ctx, span, rank1, score, hot, grmw, rmw, quant, sweep]
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shapes",
            "launches_by_path", "at_d200", "at_exact", "bmm_only_ms",
            "span_materialized_ms", "span_materialized_with_forming_ms",
            "plan_ms", "stratified_extra_ms", "bf16", "whole_ms",
            "whole_bound_ms", "export_blocks_ms", "export_blocks_plain_ms")
    print(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys if k in kd}
                                  for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
