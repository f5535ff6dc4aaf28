"""The fastText CBOW configuration's model module (benchmark/
fasttext_cbow.py) and the cell `ftcbow.subword-center`: its files load
the module and keep to the benchmark's rules; its step is
tests/plain_fasttext_cbow.py's, bit for bit; its leaves and touched rows
are the check's three; its work counts and kernel 12's match a hand
count; the reader it adds reads synthetic spans; a tiny cell of the same
flags runs correct on the CPU, and its planted faults, the control and a
step with the position weights left as they were do not."""

import dataclasses
import importlib
import time

import numpy as np
import pytest
import torch

from benchmark import cells, check, fasttext, fasttext_cbow, plain, run, \
    work
from benchmark.cells import Cell
from benchmark.kernels import pos_context as kpos
from benchmark.kernels import subword as ksub
from benchmark.metrics import pos_context_host_us_per_step
from benchmark.tests import test_bench_files as files
from benchmark.tests import tiny

SEED = 2 ** 31 + 29
CELL = "ftcbow.subword-center"
BENCH = cells.benchmark_json()


def _plain_module():
    """tests/plain_fasttext_cbow.py (the repository's root is on the
    path: benchmark/tests/conftest.py)."""
    return importlib.import_module("tests.plain_fasttext_cbow")


def test_cell_loads_the_module():
    cell = cells.load_cell(CELL, BENCH)
    assert cell.model is fasttext_cbow
    cfg = cell.cfg(SEED)
    assert cfg.model == "fasttext-cbow"
    assert (cfg.size, cfg.window, cfg.negative, cfg.sample) == (300, 5, 10,
                                                                1e-4)
    assert (cfg.minn, cfg.maxn, cfg.bucket) == (5, 5, 2_000_000)
    assert (cfg.batch_size, cfg.steps_per_chunk, cfg.alpha) == (8192, 32,
                                                                0.05)
    assert fasttext_cbow.negative_shape(cfg, 32) == (32, 8192, 10)
    assert fasttext_cbow.vocab_words is fasttext.vocab_words
    assert fasttext_cbow.bind is fasttext.bind
    assert fasttext_cbow.negative_probs is fasttext.negative_probs
    c = cell.config["corpus"]
    from benchmark.corpus import zipf_counts
    counts = zipf_counts(c["n_types"], c["head"], c["s"], c["min_count"])
    assert int(counts.sum()) == cell.config["train_tokens"] == 34759630
    assert len(counts) == cell.config["vocab_words"] == 2000000


@pytest.mark.parametrize("part", ["config", "cell"])
def test_files_keep_the_benchmark_rules(part):
    """The new configuration and cell pass test_bench_files' checks, and
    the metrics that name the cell read it."""
    if part == "config":
        entry = [c for c in BENCH["configs"]
                 if c["name"] == "fasttext-cbow-cc-en-2m-d300-1bit"][0]
        files.test_config_found_by_name(entry)
        return
    entry = [w for w in BENCH["workloads"] if w["name"] == CELL][0]
    files.test_cell_found_by_name(entry)
    assert entry["chips"] == 1
    layer = cells.cell_metrics(BENCH, CELL, "per_layer")
    assert {"pos_context_roofline.ftcbow", "subword_roofline.ftcbow",
            "pos_context_host_us_per_step.ftcbow",
            "call_setup_s.ftcbow"} <= set(layer)
    assert set(cells.cell_metrics(BENCH, CELL, "end_to_end")) == {
        "setup_s", "peak_device_GB"}
    for m in BENCH["per_layer"]:
        if m["name"] in layer:
            files.test_metric_has_a_reader(m)


def _inputs(g, V, B, W, K):
    toks = torch.randint(1, V, (B + 2 * W,), generator=g)
    sents = torch.sort(torch.randint(0, 3, (B + 2 * W,), generator=g)).values
    toks[-2:] = -1
    sents[-2:] = -1
    sents[W + 5] = 7                       # center 5 alone: n_t = 0
    shrink = torch.randint(0, W, (B,), generator=g)
    negs = torch.randint(1, V, (B, K), generator=g)
    negs[1, :2] = toks[W + 1]              # equal to the center
    return toks, sents, shrink, negs


def _cfg(bitlevel=1, reg=0.0, **kw):
    from word2bits_tpu_torch.config import config_from_argv
    argv = ["-model", "fasttext-cbow", "-size", "12", "-window", "2",
            "-negative", "3", "-batch-size", "16", "-bucket", "50",
            "-minn", "3", "-maxn", "4",
            "-bitlevel", str(bitlevel), "-reg", str(reg)]
    for k, val in kw.items():
        argv += [f"-{k}", str(val)]
    return config_from_argv(argv)


@pytest.mark.parametrize("bitlevel,reg,compute,half", [
    (1, 0.0, torch.float32, False),
    (2, 1e-3, torch.float32, False),
    (0, 0.0, torch.bfloat16, False),
    (1, 0.0, torch.float32, True),
])
def test_step_equals_the_plain_reference_bit_for_bit(bitlevel, reg, compute,
                                                     half):
    pc = _plain_module()
    V, NB, D, B, W, K = 50, 50, 12, 16, 2, 3
    words = fasttext.vocab_words(None, V)
    cfg = _cfg(bitlevel, reg)
    st = fasttext_cbow.bind(cfg, words, "cpu")
    hp = pc.bind(words, 3, 4, NB, "cpu", bitlevel=bitlevel, size=D,
                 window=W, negative=K, batch=B, reg=reg)
    g = torch.Generator().manual_seed(SEED)
    u = torch.rand(V + NB, D, generator=g) - 0.5
    v = torch.rand(V, D, generator=g) - 0.5
    d = 1.0 + 0.3 * torch.rand(2 * W, D, generator=g)
    toks, sents, shrink, negs = _inputs(g, V, B, W, K)
    ids = fasttext_cbow.touched(st, toks, negs)
    args = (toks, sents, shrink, negs, 0.03)
    kw = dict(compute=compute, half=half, block=5)
    pairs = [(i, t[i]) for i, t in zip(ids, (u, v, d))]
    a = plain.Rows.of(pairs, torch.float32)
    b = pc.Rows(pairs, torch.float32)
    la = fasttext_cbow.step(a, *args, st, **kw)
    lb = pc.step(b, *args, hp, **kw)
    for x, y, start in zip(a.leaves, b.leaves, (u, v, d)):
        assert torch.equal(x, y)
    assert torch.equal(la, lb) and a.loss_bounds == b.loss_bounds
    for x, (i, t) in zip(a.leaves, pairs):
        assert not torch.equal(x, t)       # every leaf moved


def test_leaves_and_touched_are_three():
    cfg = _cfg()
    u, v, d = torch.zeros(60, 12), torch.zeros(10, 12), torch.ones(4, 12)
    got = fasttext_cbow.leaves((u, v, d), cfg)
    assert [t is s for t, s in zip(got, (u, v, d))] == [True] * 3
    with pytest.raises(ValueError, match="three"):
        fasttext_cbow.leaves((u, v), cfg)
    with pytest.raises(ValueError, match="V \\+ 50"):
        fasttext_cbow.leaves((v, v, d), cfg)
    with pytest.raises(ValueError, match="position weights"):
        fasttext_cbow.leaves((u, v, torch.ones(3, 12)), cfg)
    words = fasttext.vocab_words(None, 10)
    st = fasttext_cbow.bind(cfg, words, "cpu")
    toks = torch.tensor([-1, -1] + list(range(1, 10)) * 2)[:20]
    negs = torch.tensor([[3, 4, 5]] * 16)
    ids = fasttext_cbow.touched(st, toks, negs)
    assert len(ids) == 3
    _, sub = fasttext.center_subwords(st, toks.clamp_min(0))
    assert torch.equal(ids[0], torch.unique(sub))
    assert torch.equal(ids[1], torch.unique(torch.cat([toks[2:18],
                                                       negs.reshape(-1)])))
    assert torch.equal(ids[2], torch.arange(4))


def test_work_counts_by_hand():
    B, W, D, K = 4, 1, 3, 2
    counts = np.array([10, 5, 5, 5, 5], dtype=np.int64)
    st = fasttext.Bound(hyper=None, offsets=None, ids=None,
                        n_sub=np.array([1, 4, 4, 10, 10]))
    shape = work.StepShape(B=B, W=W, D=D, K=K, n_negs=B * K, fused=False,
                           elt=4, counts=counts, sample=0.0,
                           model=fasttext_cbow, state=st)
    # E|G_w| 7 over the 6 slab words: 42 rows, 2 x 42 x 3 = 252; 9 x 4
    # centers x 2 positions x 3 = 216; 6 x 4 x 3 targets x 3 = 216; the
    # output adds (4 + 8) x 3 = 36
    assert shape.step_flops() == pytest.approx(252 + 216 + 216 + 36)
    assert shape.step_bytes() == pytest.approx(
        2.0 * (42 + shape.rows_v) * 3 * 4 + 2.0 * 2 * 3 * 4)
    ops, nbytes = kpos.per_step(shape)
    N, P = 6, 2
    assert ops == pytest.approx(9 * 4 * P * 3 + 4 * 3)
    assert nbytes == pytest.approx(4.0 * (
        (N * 3 + P * 3 + 4 * P + 4 * 3)
        + (4 * 3 + N * 3 + P * 3 + 4 * P + N * 3 + P * 3)))
    other = dataclasses.replace(shape, model=fasttext)
    assert kpos.per_step(other) is None
    assert ksub.per_step(shape) is not None


class _Ctx:
    def __init__(self, steps=4):
        self.trace, self.steps = None, steps


def test_pos_context_host_reader(monkeypatch):
    from benchmark import spans as S
    spans = [("epoch", 0.0, 10.0, -1), ("step", 1.0, 3.0, 0),
             ("step.pos_context", 1.0, 1.25, 1),
             ("step.pos_context_grad", 2.0, 2.5, 1),
             ("step.subword", 1.5, 2.0, 1)]
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    assert pos_context_host_us_per_step.read(_Ctx()) == pytest.approx(
        0.75 / 4 * 1e6)
    monkeypatch.setattr(S, "program_spans", lambda: spans[:2])
    assert pos_context_host_us_per_step.read(_Ctx()) is None


# set from CPU readings at this size (PERF.md §2 has the card's): the
# program's gaps far below, the control's and the faults' far above
LIMITS = dict(tiny.LIMITS, loss_gap=1e-5, rows_gap=0.01, delta_gap=1e-3)


def _tiny_cell() -> Cell:
    config = {"flags": ["-size", "16", "-window", "2", "-negative", "4",
                        "-min-count", "5", "-sample", "1e-3",
                        "-bitlevel", "1", "-model", "fasttext-cbow",
                        "-minn", "3", "-maxn", "3", "-bucket", "256"],
              "corpus": {"n_types": 400, "head": 3000, "s": 1.05,
                         "min_count": 5, "sentence": 20},
              "reference": "benchmark/fasttext_cbow.py"}
    wl = {"flags": ["-alpha", "0.05", "-batch-size", "64",
                    "-steps-per-chunk", "4", "-scatter-impl", "add"],
          "epoch_s": 0.1, "limits": dict(LIMITS)}
    return Cell(name="tiny.ftcbow", workload=wl, config=config)


LAYER = ["pos_context_host_us_per_step.t", "subword_host_us_per_step.t",
         "step_idle_pct.t", "pos_context_roofline.t", "call_setup_s.t",
         "host_words_per_s.t"]


def _run(fault=None, trace=False):
    return run.run_cell(_tiny_cell(), SEED, 0.2, trace, "cpu",
                        ["setup_s"], LAYER, time.perf_counter(),
                        fault=fault, units={m: "u" for m in
                                            ["setup_s"] + LAYER})


def test_tiny_cell_is_correct():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["rows_gap"][0] < 1e-4
    for m in ("call_setup_s.t", "pos_context_host_us_per_step.t",
              "subword_host_us_per_step.t"):
        assert m in out["metrics"]
    for m in ("step_idle_pct.t", "pos_context_roofline.t"):
        assert m not in out["metrics"]        # no device on the CPU
    assert len(out["window"]["leaf_norms"][0][0]) == 3


@pytest.mark.parametrize("fault", ["frozen", "half", "nodecay"])
def test_tiny_cell_planted_fault_is_not_correct(fault):
    out = _run(fault=fault)
    assert not out["correct"]
    c = out["checks"]
    assert max(c[k][0] / c[k][1]
               for k in ("rows_gap", "delta_gap", "loss_gap")) > 3


def _window(cell):
    from benchmark import hooks
    from benchmark.corpus import make_corpus
    from benchmark.tap import Tap
    from word2bits_tpu_torch import train
    from word2bits_tpu_torch.data.vocab import Vocab
    corpus = make_corpus(cell.config["corpus"], SEED, "cpu")
    words = hooks.of(cell.model, "vocab_words")(cell.config["corpus"],
                                                corpus.size)
    cfg = dataclasses.replace(cell.cfg(SEED), iter=1)
    tap = Tap(batch=cfg.batch_size)
    with tap:
        r = train.train(cfg, vocab=Vocab(words=words, counts=corpus.counts),
                        encoded=corpus.encoded, device="cpu")
    state = fasttext_cbow.bind(cfg, words, "cpu")
    return corpus, cfg, tap, r, state


def frozen_positions(fn):
    """The program's chunk with the position weights put back as they
    came in: the word, n-gram and output rows train, d does not."""
    def chunk(*args, **kwargs):
        keep = args[2].clone()
        out = fn(*args, **kwargs)
        out[2].copy_(keep)
        return out
    return chunk


@pytest.mark.parametrize("mode", ["control", "frozen_positions"])
def test_tiny_cell_control_and_frozen_positions_are_not_correct(mode):
    cell = _tiny_cell()
    corpus, cfg, tap, r, state = _window(cell)
    fn = tap.chunk_fn
    if mode == "frozen_positions":
        fn = frozen_positions(fn)
    got = check.step_readings(cell.model, cfg, fn, tap.engine.alias,
                              r.tables, corpus, SEED,
                              check.middle_scalars(tap.calls),
                              mode="program" if mode != "control"
                              else "control", state=state)
    lim = cell.workload["limits"]
    assert max(got[k] / lim[k]
               for k in ("rows_gap", "delta_gap", "loss_gap")) > 3
