"""Smoke run of word2bits_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from
word2bits_tpu_torch/csrc/, holds each against its plain PyTorch version at
the shapes of the shipped training configuration, checks the fused step and
chunk on the card against the same code on the CPU, and then trains that
configuration through `cli train` for at least one full 256-step chunk.
Any failed check raises, so the exit code is nonzero; without a CUDA card
(or outside a checkout) it exits nonzero before printing any result.

Output: the card's name and power limit (nvidia-smi), one line per phase,
then one JSON line {"kernels": [...]} with each kernel's launches on the
training run, its max error against the plain version, its time, the plain
version's time, its bound, and the one-call library yardstick; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
SEED = 0


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


# ---------------------------------------------------------------- kernel 1
def check_context(dev) -> dict:
    """fused_context_pallas against fused_context_plain on the card, at
    the main path's shapes, bitlevels 0/1/2/4/8.  Tolerance: outputs
    atol 1e-4 + rtol 1e-4, loss rtol 1e-5 (float summation order)."""
    from word2bits_tpu_torch.kernels.context_pallas import (
        fused_context_pallas, fused_context_plain)
    from word2bits_tpu_torch.ops.windowed import (_tile_windows,
                                                  build_banded_masks)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Nt = B // TILE
    F = TILE + 2 * W
    slab = (torch.randn((B + 2 * W, 2 * D), generator=gen, device=dev)
            * 0.3).to(torch.bfloat16)
    # sentences of ~20 tokens, a few padding positions at the end
    sents = torch.arange(B + 2 * W, device=dev) // 20
    sents[-5:] = -1
    shrink = torch.randint(0, W, (B,), generator=gen, device=dev)
    Mb, _, valid = build_banded_masks(sents, shrink, B, W, TILE)
    uwin3 = _tile_windows(slab[:, :D], Nt, TILE, W).contiguous()
    vc = slab[W:W + B, D:].contiguous()
    validf = valid.to(torch.float32)[:, None].contiguous()
    alpha = torch.full((1, 1), 0.1, device=dev)
    worst = 0.0
    for bl in (0, 1, 2, 4, 8):
        got = fused_context_pallas(uwin3, vc, Mb, validf, alpha, bl)
        want = fused_context_plain(uwin3, vc, Mb, validf, alpha, bl)
        torch.cuda.synchronize()
        for name, g, w in zip(("cavg", "cavge", "dv_center", "af"), got,
                              want):
            if not torch.allclose(g, w, atol=1e-4, rtol=1e-4):
                _fail(f"context kernel {name} at bitlevel {bl}: max abs "
                      f"err {_max_err(g, w):.3e} > atol 1e-4 + rtol 1e-4")
            worst = max(worst, _max_err(g, w))
        lg, lw = float(got[4]), float(want[4])
        if not math.isfinite(lg) or abs(lg - lw) > 1e-5 * abs(lw):
            _fail(f"context kernel loss at bitlevel {bl}: {lg} vs {lw}")
        print(f"[context] bitlevel {bl}: max abs err "
              f"{max(_max_err(g, w) for g, w in zip(got[:4], want[:4])):.3e}"
              f", loss {lg:.6f} vs plain {lw:.6f}")
    args = (uwin3, vc, Mb, validf, alpha, 1)
    ms = _time_ms(lambda: fused_context_pallas(*args))
    plain_ms = _time_ms(lambda: fused_context_plain(*args))
    # bytes: each input read once, each output written once
    nbytes = sum(t.numel() * t.element_size()
                 for t in (uwin3, vc, Mb, validf, alpha))
    nbytes += 3 * B * D * 4 + B * 4 + 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[context] bitlevel 1 kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    return dict(name="fused_context_pallas", route="cuda",
                source="word2bits_tpu_torch/csrc/context.cu",
                replaces="word2bits_tpu/kernels/context_pallas.py:82",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


# ---------------------------------------------------------------- kernel 2
def check_span(dev) -> dict:
    """The span scatter kernel against scatter_add_span_plain on the card:
    a bf16 [70000, 400] table, Zipf ids with duplicates plus drop
    sentinels, float32 rows.  Both sum each id's bf16-rounded rows in
    float32 and round once into the table, in another order, so they agree
    to one bf16 rounding: atol 1e-5 + rtol 2^-7."""
    from word2bits_tpu_torch.kernels.span_scatter import (
        SENTINEL, scatter_add_span_plain, scatter_add_span_planned,
        span_plan)
    rng = np.random.default_rng(SEED)
    V, C, N = SCATTER_V, 2 * D, SCATTER_N
    # one step's ids on the Zipf(1.05) corpus: B+2W slab ids from the
    # subsampled (-sample 1e-3) unigram, the negatives from unigram^0.75,
    # plus drop sentinels
    p = np.arange(1, V + 1, dtype=np.float64) ** -1.05
    p /= p.sum()
    p_kept = p * np.minimum((np.sqrt(p / 1e-3) + 1.0) * 1e-3 / p, 1.0)
    p_neg = p ** 0.75
    n_slab = B + 2 * W
    ids_np = np.concatenate([
        rng.choice(V, n_slab, p=p_kept / p_kept.sum()),
        rng.choice(V, N - n_slab, p=p_neg / p_neg.sum())])
    ids_np[rng.choice(N, 64, replace=False)] = SENTINEL
    ids = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
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
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


# ------------------------------------------------------- step and chunk
def check_step_and_chunk(dev) -> None:
    """The fused step and a 3-step chunk on the card (kernels) against the
    same calls on the CPU (plain versions), at a small shape with injected
    draws, float32 table: atol 1e-4 + rtol 1e-4, loss rtol 1e-5."""
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
    outs = {}
    for where in ("cpu", dev):
        args = [t.to(where) for t in inputs]
        tab, loss = cf.fused_slab_step(
            table.clone().to(where), SlabInputs(*args),
            torch.tensor(0.05, device=where), hyper, b, g, neg_pool=p,
            banded=8, scatter_impl="span", context_pallas=True)
        chunk = cf.make_fused_train_chunk(hyper, v, b, s, neg_sharing=g,
                                          neg_pool=p, banded=8,
                                          scatter_impl="span",
                                          context_pallas=True)
        sc = ChunkScalars(base0=w, alpha0=0.05, wca_start=100.0,
                          wca_per_step=float(b), denom=1e4)
        ctab, closs = chunk(table.clone().to(where), tokens.to(where),
                            sents.to(where),
                            build_alias_table(np.ones(v)).to(where), sc,
                            shrinks=shrinks.to(where), negs=negs.to(where))
        outs[str(where)] = (tab.cpu(), float(loss), ctab.cpu(), float(closs))
    (t0, l0, c0, cl0), (t1, l1, c1, cl1) = outs["cpu"], outs[str(dev)]
    for name, a, bb in (("step", t1, t0), ("chunk", c1, c0)):
        if not torch.allclose(a, bb, atol=1e-4, rtol=1e-4):
            _fail(f"{name} on the card vs the CPU: max abs err "
                  f"{_max_err(a, bb):.3e}")
    for name, a, bb in (("step loss", l1, l0), ("chunk loss", cl1, cl0)):
        if abs(a - bb) > 1e-5 * abs(bb) + 1e-6:
            _fail(f"{name} on the card {a} vs the CPU {bb}")
    print(f"[step] card vs CPU: step max abs err {_max_err(t1, t0):.3e}, "
          f"chunk {_max_err(c1, c0):.3e}, losses {l1:.6f}/{l0:.6f}, "
          f"{cl1:.6f}/{cl0:.6f}")


# ------------------------------------------------------------ main path
def train_main_path(work: str) -> dict:
    """`cli train` on a synthetic text8-like corpus at the shipped flags;
    returns its launch counts and rates."""
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
    return launches


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

    kernels = [check_context(dev), check_span(dev)]
    check_step_and_chunk(dev)
    work = os.path.join(repo, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        launches = train_main_path(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys}
                                  for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
