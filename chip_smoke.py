"""Smoke run of word2bits_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from
word2bits_tpu_torch/csrc/ (one nvcc per source, all at once), holds each
against its plain PyTorch version at the shapes of the paths that run it,
checks the fused step and chunk on the card against the same code on the
CPU, and then drives the port's two training paths through their entry
points, each with the kernels' launch counts set to 0 just before and read
just after:

  [train]     the shipped throughput configuration (the JAX package's
              bench.py CFG plus ctx_span_banded256_S256: size 200, span
              scatter) through `cli train`, one epoch of a 17M-token corpus;
  [flagship]  the full-Wikipedia capacity configuration of
              docs/large_vocab.md:19-25 (V = 3,699,941, size 800, B = 16384,
              grmw scatter, -loop-mode fori, -packed 1) through
              `train.train`, 64 steps, then its `.pack` export read back;
  [accuracy]  `cli accuracy` on that `.pack` and on [train]'s vector file,
              each transcript checked against the CPU evaluator.

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
# one flagship step's update rows: B+2W slab rows plus (B/64) * 24
# negatives (one pool)
FLAG_N = FLAG_B + 2 * W + (FLAG_B // 64) * 24
# Zipf(1.05) head of the synthetic vocabulary: count(r) = max(5, C r^-1.05)
FLAG_ZIPF_C = 700_000
ACC_THRESHOLD = 1_000_000        # rows of the .pack the evaluator reads
ACC_QUESTIONS = 1200

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
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
def check_context(dev, b: int, d: int, tag: str) -> dict:
    """fused_context_pallas against fused_context_plain on the card at
    B = b, D = d, W = 8, tile 256, bitlevels 0/1/2/4/8.

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
    from word2bits_tpu_torch.ops.windowed import (_tile_windows,
                                                  build_banded_masks)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Nt = b // TILE
    slab = (torch.randn((b + 2 * W, 2 * d), generator=gen, device=dev)
            * 0.3).to(torch.bfloat16)
    # sentences of ~20 tokens, a few padding positions at the end
    sents = torch.arange(b + 2 * W, device=dev) // 20
    sents[-5:] = -1
    shrink = torch.randint(0, W, (b,), generator=gen, device=dev)
    Mb, _, valid = build_banded_masks(sents, shrink, b, W, TILE)
    uwin3 = _tile_windows(slab[:, :d], Nt, TILE, W).contiguous()
    vc = slab[W:W + b, d:].contiguous()
    validf = valid.to(torch.float32)[:, None].contiguous()
    alpha = torch.full((1, 1), 0.1, device=dev)
    worst = 0.0
    for bl in (0, 1, 2, 4, 8):
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
            _fail(f"context kernel at bitlevel {bl}: {n_edge} centers at a "
                  "score edge (more than 5%)")
        keep = ~edge
        errs = []
        for name, g, w in zip(("cavg", "cavge", "dv_center", "af"), got,
                              want):
            g, w = g[keep], w[keep]
            if not torch.allclose(g, w, atol=1e-4, rtol=1e-4):
                _fail(f"context kernel {name} at bitlevel {bl}: max abs "
                      f"err {_max_err(g, w):.3e} > atol 1e-4 + rtol 1e-4")
            errs.append(_max_err(g, w))
        worst = max(worst, *errs)
        lg, lw = float(got[4]), float(want[4])
        allow = (1e-5 * abs(lw) + _JUMP_LO * int(lo.sum())
                 + _JUMP_HI * int(hi.sum()))
        if not math.isfinite(lg) or abs(lg - lw) > allow:
            _fail(f"context kernel loss at bitlevel {bl}: {lg} vs {lw} "
                  f"(allowed {allow:.4g})")
        print(f"[{tag}] bitlevel {bl}: max abs err {max(errs):.3e} over "
              f"{b - n_edge} centers ({n_edge} at a score edge, "
              f"{int(lo.sum() + hi.sum())} of them at +-6), loss "
              f"{lg:.6f} vs plain {lw:.6f}")
    args = (uwin3, vc, Mb, validf, alpha, 1)
    ms = _time_ms(lambda: fused_context_pallas(*args))
    plain_ms = _time_ms(lambda: fused_context_plain(*args))
    # bytes: each input read once, each output written once
    nbytes = sum(t.numel() * t.element_size()
                 for t in (uwin3, vc, Mb, validf, alpha))
    nbytes += 3 * b * d * 4 + b * 4 + 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] bitlevel 1 kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    return dict(name="fused_context_pallas", route="cuda",
                source="word2bits_tpu_torch/csrc/context.cu",
                replaces="word2bits_tpu/kernels/context_pallas.py:82",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                shapes=f"B={b}, D={d}, W={W}, tile {TILE}, bf16 rows")


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


# ------------------------------------------------------- step and chunk
def check_step_and_chunk(dev) -> None:
    """The fused step and a 3-step chunk on the card (kernels) against the
    same calls on the CPU (plain versions), at a small shape with injected
    draws, float32 table, with the span scatter and with the grmw scatter
    under -loop-mode fori: atol 1e-4 + rtol 1e-4, loss rtol 1e-5."""
    from word2bits_tpu_torch.models import cbow_fused as cf
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.models.cbow_slab import SlabInputs
    from word2bits_tpu_torch.sampling.unigram import build_alias_table
    rng = np.random.default_rng(SEED)
    v, d, b, w, k, g, p, s = 300, 16, 64, 3, 5, 8, 2, 3
    hyper = CBOWHyper(bitlevel=1, size=d, window=w, negative=k)
    n = s * b + 2 * w + 10
    tokens = torch.from_numpy(rng.integers(0, v, n))
    tokens[:w] = -1
    sents = torch.arange(n) // 23
    sents[:w] = -1
    shrinks = torch.from_numpy(rng.integers(0, w, (s, b)))
    negs = torch.from_numpy(rng.integers(1, v, (s, b // g, p * k)))
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (v, 2 * d))
                             .astype(np.float32))
    inputs = SlabInputs(tokens[:b + 2 * w], sents[:b + 2 * w], shrinks[0],
                        negs[0])
    for simpl, loop_mode in (("span", "scan"), ("grmw", "fori")):
        outs = {}
        for where in ("cpu", dev):
            args = [t.to(where) for t in inputs]
            tab, loss = cf.fused_slab_step(
                table.clone().to(where), SlabInputs(*args),
                torch.tensor(0.05, device=where), hyper, b, g, neg_pool=p,
                banded=8, scatter_impl=simpl, context_pallas=True)
            chunk = cf.make_fused_train_chunk(hyper, v, b, s, neg_sharing=g,
                                              neg_pool=p, banded=8,
                                              scatter_impl=simpl,
                                              context_pallas=True,
                                              loop_mode=loop_mode)
            sc = ChunkScalars(base0=w, alpha0=0.05, wca_start=100.0,
                              wca_per_step=float(b), denom=1e4)
            ctab, closs = chunk(table.clone().to(where), tokens.to(where),
                                sents.to(where),
                                build_alias_table(np.ones(v)).to(where), sc,
                                shrinks=shrinks.to(where),
                                negs=negs.to(where))
            outs[str(where)] = (tab.cpu(), float(loss), ctab.cpu(),
                                float(closs))
        (t0, l0, c0, cl0), (t1, l1, c1, cl1) = outs["cpu"], outs[str(dev)]
        for name, a, bb in (("step", t1, t0), ("chunk", c1, c0)):
            if not torch.allclose(a, bb, atol=1e-4, rtol=1e-4):
                _fail(f"{simpl} {name} on the card vs the CPU: max abs err "
                      f"{_max_err(a, bb):.3e}")
        for name, a, bb in (("step loss", l1, l0), ("chunk loss", cl1, cl0)):
            if abs(a - bb) > 1e-5 * abs(bb) + 1e-6:
                _fail(f"{simpl} {name} on the card {a} vs the CPU {bb}")
        print(f"[step] {simpl} ({loop_mode}) card vs CPU: step max abs err "
              f"{_max_err(t1, t0):.3e}, chunk {_max_err(c1, c0):.3e}, "
              f"losses {l1:.6f}/{l0:.6f}, {cl1:.6f}/{cl0:.6f}")


# ------------------------------------------------- [train]: shipped path
def train_main_path(work: str):
    """`cli train` on a synthetic text8-like corpus at the shipped flags;
    returns its launch counts and the vector file."""
    from word2bits_tpu_torch import cli
    from word2bits_tpu_torch.data.synthetic import zipf_corpus
    from word2bits_tpu_torch.io.vectors import read_vectors
    from word2bits_tpu_torch.kernels.context_pallas import \
        fused_context_pallas
    from word2bits_tpu_torch.kernels.span_scatter import \
        scatter_add_span_planned

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
    fused_context_pallas.launches = 0
    scatter_add_span_planned.launches = 0
    with contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
        rc = cli.train_main(["-train", corpus, "-output", out] + TRAIN_FLAGS)
    launches = {"fused_context_pallas": fused_context_pallas.launches,
                "scatter_add_span": scatter_add_span_planned.launches}
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
    for name, n in launches.items():
        if n <= 0:
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
    return launches, out


# ------------------------------------------- [flagship]: capacity path
def train_flagship(work: str, dev) -> tuple:
    """The capacity configuration through train.train for FLAG_STEPS
    steps, its vectors and .pack written in row blocks; returns the
    launch counts and the .pack path."""
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.synthetic import zipf_vocab_corpus
    from word2bits_tpu_torch.io.packed import read_packed
    from word2bits_tpu_torch.kernels.context_pallas import \
        fused_context_pallas
    from word2bits_tpu_torch.kernels.group_rmw import \
        scatter_add_grmw_planned
    from word2bits_tpu_torch.ops.quantize import quantize

    # the runbook's flags; the output goes to the work directory, in the
    # binary format (its text format would format 2.96G values)
    out = os.path.join(work, "flagship.bin")
    flags = list(FLAGSHIP_FLAGS)
    flags[flags.index("-output") + 1] = out
    cfg = config_from_argv(flags + ["-binary", "1", "-debug", "1"])
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
        fused_context_pallas.launches = 0
        scatter_add_grmw_planned.launches = 0
        res = T.train(cfg, vocab=vocab, encoded=encoded,
                      max_steps=FLAG_STEPS, device=dev)
    launches = {"fused_context_pallas": fused_context_pallas.launches,
                "scatter_add_grmw": scatter_add_grmw_planned.launches}
    peak = torch.cuda.max_memory_allocated()
    rss_life = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if res.steps != FLAG_STEPS:
        _fail(f"flagship trained {res.steps} steps, not {FLAG_STEPS}")
    for name, n in launches.items():
        if n != res.steps:
            _fail(f"flagship: {name} launched {n} times in {res.steps} "
                  "steps (once per step expected)")
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
        blk = res.table[r0:r0 + step]
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
          f" bytes, export {res.seconds['export']:.1f} s; read back as "
          f"{n_rows} x {FLAG_D} of +-1/3 equal to the trained table in "
          f"{time.perf_counter() - t0:.1f} s")
    return launches, pack


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
    libs = build_all()
    print(f"[build] {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")

    ctx200 = check_context(dev, B, D, "context")
    span = check_span(dev)
    check_step_and_chunk(dev)
    grmw = check_grmw(dev)
    ctx = check_context(dev, FLAG_B, FLAG_D, "context@800")
    work = os.path.join(repo, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        by_path = {"train": train_main_path(work)}
        launches, vec_path = by_path["train"]
        by_path["flagship"] = train_flagship(work, dev)
        check_accuracy(dev, by_path["flagship"][1], ACC_THRESHOLD,
                       ACC_QUESTIONS, "flagship.pack")
        check_accuracy(dev, vec_path, 0, 2000, "train.bin")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ctx["at_d200"] = {k: ctx200[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "shapes")}
    kernels = [ctx, span, grmw]
    for k in kernels:
        k["launches_by_path"] = {p: c[0].get(k["name"], 0)
                                 for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shapes",
            "launches_by_path", "at_d200")
    print(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys if k in kd}
                                  for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
