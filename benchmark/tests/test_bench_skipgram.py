"""The skip-gram configuration's model module (benchmark/skipgram.py) and
the cell `sgns.pair-add`: its files load the module; its step is
tests/plain_skipgram.py's, bit for bit; its work counts match a hand
count; the two readers it adds read synthetic traces; a tiny cell of the
same flags runs correct on the CPU and its planted faults do not; on
the card, the program's per-pair chunk at the published widths against
the reference."""

import dataclasses
import importlib.util
import os
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import cells, check, plain, run, skipgram, work
from benchmark.cells import ROOT, Cell
from benchmark.metrics import sort_us_per_step, step_idle_pct
from benchmark.tests import tiny
from benchmark.trace import Trace

SEED = 2 ** 31 + 19


def _plain_module():
    """tests/plain_skipgram.py, by its path (tests/ is no package)."""
    name = "tests_plain_skipgram"
    if name not in sys.modules:
        path = os.path.join(ROOT, "tests", "plain_skipgram.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod          # its dataclasses look it up
        spec.loader.exec_module(mod)
    return sys.modules[name]


def test_cell_loads_the_skipgram_module():
    cell = cells.load_cell("sgns.pair-add", cells.benchmark_json())
    assert cell.model is skipgram
    cfg = cell.cfg(SEED)
    assert cfg.model == "skipgram" and cfg.neg_per_pair
    assert (cfg.size, cfg.window, cfg.negative) == (300, 5, 15)
    assert skipgram.negative_shape(cfg, 32) == (32, 8192, 150)
    hp = skipgram.hyper(cfg)
    assert (hp.batch, hp.reg) == (8192, 0.0)
    # the configuration's corpus as PERF.md gives it
    c = cell.config["corpus"]
    from benchmark.corpus import zipf_counts
    counts = zipf_counts(c["n_types"], c["head"], c["s"], c["min_count"])
    assert int(counts.sum()) == cell.config["train_tokens"] == 28219630
    assert len(counts) == cell.config["vocab_words"] == 692000


def test_hyper_refuses_a_configuration_without_per_pair_draws():
    cell = cells.load_cell("sgns.pair-add")
    with pytest.raises(ValueError, match="neg-per-pair"):
        skipgram.hyper(dataclasses.replace(cell.cfg(SEED),
                                           neg_per_pair=False))


def _inputs(g, V, B, W, K):
    toks = torch.randint(1, V, (B + 2 * W,), generator=g)
    sents = torch.sort(torch.randint(0, 3, (B + 2 * W,), generator=g)).values
    toks[-2:] = -1
    sents[-2:] = -1
    shrink = torch.randint(0, W, (B,), generator=g)
    negs = torch.randint(1, V, (B, 2 * W * K), generator=g)
    negs[1, :K] = toks[W + 1]
    return toks, sents, shrink, negs


@pytest.mark.parametrize("bitlevel,reg,compute,half", [
    (1, 0.0, torch.float32, False),
    (2, 1e-3, torch.float32, False),
    (0, 0.0, torch.bfloat16, False),
    (1, 0.0, torch.float32, True),
])
def test_step_equals_the_plain_reference_bit_for_bit(bitlevel, reg, compute,
                                                     half):
    ps = _plain_module()
    V, D, B, W, K = 50, 12, 16, 2, 3
    g = torch.Generator().manual_seed(SEED)
    u = torch.rand(V, D, generator=g) - 0.5
    v = torch.rand(V, D, generator=g) - 0.5
    toks, sents, shrink, negs = _inputs(g, V, B, W, K)
    ids = torch.unique(torch.cat([toks.clamp_min(0), negs.reshape(-1)]))
    args = (toks, sents, shrink, negs, 0.03)
    kw = dict(compute=compute, half=half, block=5)
    a = plain.Rows(ids, u[ids], v[ids], torch.float32)
    b = ps.Rows(ids, u[ids], v[ids], torch.float32)
    la = skipgram.step(a, *args, skipgram.Hyper(bitlevel, D, W, K, B, reg),
                       **kw)
    lb = ps.step(b, *args, ps.Hyper(bitlevel, D, W, K, B, reg), **kw)
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
    assert torch.equal(la, lb) and a.loss_bounds == b.loss_bounds
    assert not torch.equal(a.v, v[ids])


def test_blocks_do_not_change_the_step():
    V, D, B, W, K = 40, 8, 12, 2, 2
    g = torch.Generator().manual_seed(3)
    u = torch.rand(V, D, generator=g) - 0.5
    v = torch.rand(V, D, generator=g) - 0.5
    toks, sents, shrink, negs = _inputs(g, V, B, W, K)
    ids = torch.arange(V)
    hp = skipgram.Hyper(1, D, W, K, B)
    out = []
    for block in (B, 5):
        rows = plain.Rows(ids, u, v, torch.float32)
        loss = skipgram.step(rows, toks, sents, shrink, negs, 0.05, hp,
                             block=block)
        out.append((rows.u, rows.v, float(loss)))
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-7, rtol=0)
    torch.testing.assert_close(out[0][1], out[1][1], atol=1e-7, rtol=0)
    assert out[0][2] == pytest.approx(out[1][2], rel=1e-6)


def test_work_counts_by_hand():
    B, W, D, K = 4, 1, 3, 2
    counts = np.array([10, 5, 5, 5, 5], dtype=np.int64)
    shape = work.StepShape(B=B, W=W, D=D, K=K, n_negs=B * 2 * W * K,
                           fused=False, elt=4, counts=counts, sample=0.0,
                           model=skipgram)
    # 8 pairs x 3 targets x 3 products of 2D = 432; the u sums 8 x D = 24;
    # the adds: (4 centers + 16 negatives + 6 slab rows) x D = 78
    assert shape.step_flops() == 432 + 24 + 78
    assert shape.step_bytes() == 2.0 * (shape.rows_slab + shape.rows_v) * 12
    # the split tables' two sorted scatters in kernel 2's count
    from benchmark.kernels import span_scatter
    ops, nbytes = span_scatter.per_step(shape)
    assert ops == (4 + 16 + 6) * D
    assert nbytes == (work.span_bytes(20, D, shape.rows_v, 4)
                      + work.span_bytes(6, D, shape.rows_slab, 4))


class _Ctx:
    def __init__(self, trace, steps=2):
        self.trace, self.steps = trace, steps


def test_step_idle_and_sort_readers(monkeypatch):
    # one epoch 0..10 s: busy 0-1, 3-4, 6-10; gaps 1-3 (middle 2, in
    # step.gather) and 4-6 (middle 5, in `chunk` only)
    tr = Trace(device=[("void cub::DeviceRadixSortOnesweepKernel<int>", 0, 1),
                       ("tile_scatter_kernel<w2b::TileCfg<64>", 3, 4),
                       ("sortKeyValueInplace", 6, 7),
                       ("elementwise_kernel", 7, 10)], wall_s=10.0)
    spans = [("epoch", 0.0, 10.0, -1), ("chunk", 0.5, 9.0, 0),
             ("step", 0.5, 3.5, 1), ("step.gather", 1.5, 2.5, 2),
             ("step.scatter", 2.5, 3.5, 2), ("step", 4.5, 8.0, 1)]
    from benchmark import spans as S
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    assert step_idle_pct.read(_Ctx(tr)) == pytest.approx(20.0)
    assert sort_us_per_step.read(_Ctx(tr)) == pytest.approx(1e6)
    monkeypatch.setattr(S, "program_spans",
                        lambda: [s for s in spans if "." not in s[0]])
    assert step_idle_pct.read(_Ctx(tr)) is None
    none = Trace(device=[("elementwise_kernel", 0, 1)], wall_s=1.0)
    assert sort_us_per_step.read(_Ctx(none)) is None
    assert sort_us_per_step.read(_Ctx(None)) is None


# set from CPU readings at this size: the program's loss_gap 0, rows_gap
# 5.5e-6, delta_gap 3.7e-7; the control's 5.7e-5, 0.177, 0.0103
LIMITS = dict(tiny.LIMITS, loss_gap=1e-5, rows_gap=0.01, delta_gap=1e-3)


def _tiny_cell() -> Cell:
    config = {"flags": ["-size", "16", "-window", "2", "-negative", "3",
                        "-min-count", "5", "-sample", "1e-3",
                        "-bitlevel", "1", "-model", "skipgram",
                        "-neg-per-pair", "1"],
              "corpus": {"n_types": 400, "head": 3000, "s": 1.05,
                         "min_count": 5, "sentence": 20},
              "reference": "benchmark/skipgram.py"}
    wl = {"flags": ["-alpha", "0.025", "-batch-size", "64",
                    "-steps-per-chunk", "4", "-scatter-impl", "add"],
          "epoch_s": 0.1, "limits": dict(LIMITS)}
    return Cell(name="tiny.sgns", workload=wl, config=config)


LAYER = ["step_idle_pct.t", "sort_us_per_step.t", "step_mfu.t",
         "call_setup_s.t", "host_words_per_s.t"]


def _run(fault=None, trace=False):
    return run.run_cell(_tiny_cell(), SEED, 0.2, trace, "cpu",
                        ["setup_s"], LAYER, time.perf_counter(),
                        fault=fault, units={m: "u" for m in
                                            ["setup_s"] + LAYER})


def test_tiny_cell_is_correct_and_reads_no_device_metric():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["rows_gap"][0] < 1e-4
    assert "call_setup_s.t" in out["metrics"]
    for m in ("step_idle_pct.t", "sort_us_per_step.t", "step_mfu.t"):
        assert m not in out["metrics"]        # no device on the CPU


@pytest.mark.parametrize("fault", ["frozen", "half", "nodecay"])
def test_tiny_cell_planted_fault_is_not_correct(fault):
    out = _run(fault=fault)
    assert not out["correct"]
    c = out["checks"]
    assert max(c[k][0] / c[k][1]
               for k in ("rows_gap", "delta_gap", "loss_gap")) > 3


def test_tiny_cell_control_is_not_correct():
    from benchmark.corpus import make_corpus, word_names
    from benchmark.tap import Tap
    from word2bits_tpu_torch import train
    from word2bits_tpu_torch.data.vocab import Vocab
    cell = _tiny_cell()
    corpus = make_corpus(cell.config["corpus"], SEED, "cpu")
    vocab = Vocab(words=word_names(corpus.size), counts=corpus.counts)
    cfg = dataclasses.replace(cell.cfg(SEED), iter=1)
    tap = Tap(batch=cfg.batch_size)
    with tap:
        r = train.train(cfg, vocab=vocab, encoded=corpus.encoded,
                        device="cpu")
    got = check.step_readings(cell.model, cfg, tap.chunk_fn,
                              tap.engine.alias, r.tables, corpus, SEED,
                              check.middle_scalars(tap.calls),
                              mode="control")
    lim = cell.workload["limits"]
    assert max(got[k] / lim[k]
               for k in ("rows_gap", "delta_gap", "loss_gap")) > 3


@pytest.mark.cuda
@pytest.mark.parametrize("bitlevel", [0, 1])
def test_pair_chunk_at_published_widths_on_the_card(card, bitlevel):
    """The program's per-pair chunk (D 300, W 5, K 15, B 256, two steps,
    injected draws) against the reference's steps, on the card.  Bitlevel
    0: element by element (float32 sums in another order).  Bitlevel 1:
    scores are multiples of 1/9 and about 5% land on 0, where the float
    order picks the table sigmoid's bin, so the gap is the check's norm
    gap (plain.rows_gap)."""
    from word2bits_tpu_torch.models import cbow as tcbow
    from word2bits_tpu_torch.models import skipgram as tsg
    from word2bits_tpu_torch.sampling.unigram import build_alias_table
    torch.backends.cuda.matmul.allow_tf32 = False
    Vn, D, B, W, K, S = 5000, 300, 256, 5, 15, 2
    g = torch.Generator(device=card).manual_seed(SEED)
    u = (torch.rand(Vn, D, generator=g, device=card) - 0.5) * 0.2
    v = (torch.rand(Vn, D, generator=g, device=card) - 0.5) * 0.2
    n = S * B
    toks = torch.full((n + 2 * W,), -1, dtype=torch.long, device=card)
    sents = torch.full_like(toks, -1)
    toks[W:W + n] = torch.randint(1, Vn, (n,), generator=g, device=card)
    sents[W:W + n] = torch.arange(n, device=card) // 20
    shrinks = torch.randint(0, W, (S, B), generator=g, device=card)
    negs = torch.randint(1, Vn, (S, B, 2 * W * K), generator=g, device=card)
    hk = tcbow.CBOWHyper(bitlevel=bitlevel, size=D, window=W, negative=K)
    sc = tcbow.ChunkScalars(base0=W, alpha0=0.025, wca_start=0.0,
                            wca_per_step=float(B), denom=1e6)
    chunk = tsg.make_skipgram_train_chunk(hk, Vn, B, S, neg_per_pair=True)
    atab = build_alias_table(np.ones(Vn)).to(card)
    tu, tv, tl = chunk(u.clone(), v.clone(), toks, sents, atab, sc,
                       n_steps=S, shrinks=shrinks, negs=negs)
    alphas = tcbow.step_alphas(sc, S, card)
    hp = skipgram.Hyper(bitlevel, D, W, K, B)
    ids = torch.arange(Vn, device=card)
    ref = plain.Rows(ids, u, v, torch.float32)
    start = plain.Rows(ids, u, v, torch.float32)
    loss = 0.0
    for s in range(S):
        lo = W + s * B - W
        loss += float(skipgram.step(ref, toks[lo:lo + B + 2 * W],
                                    sents[lo:lo + B + 2 * W], shrinks[s],
                                    negs[s], float(alphas[s]), hp))
    got = plain.Rows(ids, tu, tv, torch.float32)
    gap = plain.rows_gap(got, ref, start)
    assert float(tl) == pytest.approx(loss, rel=1e-5)
    if bitlevel == 0:
        torch.testing.assert_close(tu, ref.u, atol=2e-6, rtol=0)
        torch.testing.assert_close(tv, ref.v, atol=2e-6, rtol=0)
        assert gap < 1e-4
    else:
        assert gap < 0.05
