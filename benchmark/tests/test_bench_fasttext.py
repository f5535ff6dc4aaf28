"""The fastText configuration's model module (benchmark/fasttext.py) and
the cell `fasttext.subword-pair`: its files load the module; its step is
tests/plain_fasttext.py's, bit for bit; its `bind` equals the plain
per-word subword rows; its words are spelled as its doc says; its work
counts and the kernel's match a hand count; the reader it adds reads
synthetic spans; a tiny cell of the same flags runs correct on the CPU
and its planted faults do not, a step with the bucket rows left as they
were among them."""

import dataclasses
import importlib.util
import os
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import cells, check, fasttext, plain, run, work
from benchmark.cells import ROOT, Cell
from benchmark.kernels import subword as ksub
from benchmark.metrics import subword_host_us_per_step
from benchmark.tests import tiny

SEED = 2 ** 31 + 23


def _plain_module():
    """tests/plain_fasttext.py, by its path (tests/ is no package)."""
    name = "tests_plain_fasttext"
    if name not in sys.modules:
        path = os.path.join(ROOT, "tests", "plain_fasttext.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod          # its dataclasses look it up
        spec.loader.exec_module(mod)
    return sys.modules[name]


def test_cell_loads_the_fasttext_module():
    cell = cells.load_cell("fasttext.subword-pair", cells.benchmark_json())
    assert cell.model is fasttext
    cfg = cell.cfg(SEED)
    assert cfg.model == "fasttext"
    assert (cfg.size, cfg.window, cfg.negative, cfg.sample) == (300, 5, 5,
                                                                1e-4)
    assert (cfg.minn, cfg.maxn, cfg.bucket) == (3, 6, 2_000_000)
    assert (cfg.batch_size, cfg.steps_per_chunk, cfg.alpha) == (8192, 32,
                                                                0.05)
    assert fasttext.negative_shape(cfg, 32) == (32, 8192, 50)
    c = cell.config["corpus"]
    from benchmark.corpus import zipf_counts
    counts = zipf_counts(c["n_types"], c["head"], c["s"], c["min_count"])
    assert int(counts.sum()) == cell.config["train_tokens"] == 44104106
    assert len(counts) == cell.config["vocab_words"] == 2519370


def test_spelled_words():
    words = fasttext.vocab_words(None, 700 + 490_000 + 50)
    assert words[0] == "</s>" and words[1:3] == ["ba", "be"]
    assert len(set(words)) == len(words)
    # one syllable for the 700 most frequent, two for the next 490,000
    assert words[700] == "zuk" and len(words[701]) in (4, 5, 6)
    assert 6 <= len(words[-1]) <= 9
    lens = [len(w) for w in words[1:]]
    assert lens[:700] == sorted(lens[:700])
    assert max(lens[:700]) <= 3 < min(lens[700:])


def _inputs(g, V, B, W, K):
    toks = torch.randint(1, V, (B + 2 * W,), generator=g)
    sents = torch.sort(torch.randint(0, 3, (B + 2 * W,), generator=g)).values
    toks[-2:] = -1
    sents[-2:] = -1
    shrink = torch.randint(0, W, (B,), generator=g)
    negs = torch.randint(1, V, (B, 2 * W * K), generator=g)
    negs[1, :K] = toks[1]                 # center 1, offset -W: its target
    return toks, sents, shrink, negs


def _cfg(bitlevel=1, reg=0.0, **kw):
    from word2bits_tpu_torch.config import config_from_argv
    argv = ["-model", "fasttext", "-size", "12", "-window", "2",
            "-negative", "3", "-batch-size", "16", "-bucket", "50",
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
    pf = _plain_module()
    V, NB, D, B, W, K = 50, 50, 12, 16, 2, 3
    words = fasttext.vocab_words(None, V)
    cfg = _cfg(bitlevel, reg)
    st = fasttext.bind(cfg, words, "cpu")
    hp = pf.bind(words, 3, 6, NB, "cpu", bitlevel=bitlevel, size=D,
                 window=W, negative=K, batch=B, reg=reg)
    g = torch.Generator().manual_seed(SEED)
    u = torch.rand(V + NB, D, generator=g) - 0.5
    v = torch.rand(V, D, generator=g) - 0.5
    toks, sents, shrink, negs = _inputs(g, V, B, W, K)
    ids = fasttext.touched(st, toks, negs)
    args = (toks, sents, shrink, negs, 0.03)
    kw = dict(compute=compute, half=half, block=5)
    a = plain.Rows.of([(ids[0], u[ids[0]]), (ids[1], v[ids[1]])],
                      torch.float32)
    b = pf.Rows([(ids[0], u[ids[0]]), (ids[1], v[ids[1]])], torch.float32)
    la = fasttext.step(a, *args, st, **kw)
    lb = pf.step(b, *args, hp, **kw)
    assert torch.equal(a.leaves[0], b.leaves[0])
    assert torch.equal(a.leaves[1], b.leaves[1])
    assert torch.equal(la, lb) and a.loss_bounds == b.loss_bounds
    assert not torch.equal(a.leaves[0], u[ids[0]])


@pytest.mark.parametrize("minn,maxn", [(3, 6), (1, 4), (2, 0)])
def test_bind_equals_the_plain_subword_rows(minn, maxn):
    pf = _plain_module()
    words = fasttext.vocab_words(None, 900) + ["é-x", "</s>"]
    cfg = _cfg(minn=minn, maxn=maxn, bucket=1 << 20)
    st = fasttext.bind(cfg, words, "cpu")
    hp = pf.bind(words, minn, maxn, 1 << 20, "cpu", bitlevel=1, size=4,
                 window=1, negative=1, batch=1)
    assert torch.equal(st.offsets, hp.offsets)
    assert torch.equal(st.ids, hp.ids)
    assert np.array_equal(st.n_sub, (hp.offsets[1:] - hp.offsets[:-1])
                          .numpy())


def test_bind_in_blocks_equals_one_block(monkeypatch):
    words = fasttext.vocab_words(None, 1000)
    cfg = _cfg()
    one = fasttext.bind(cfg, words, "cpu")
    monkeypatch.setattr(fasttext, "BIND_WORDS", 77)
    many = fasttext.bind(cfg, words, "cpu")
    assert torch.equal(one.offsets, many.offsets)
    assert torch.equal(one.ids, many.ids)


def test_leaves_refuse_tables_without_the_buckets():
    cfg = _cfg()
    u, v = torch.zeros(60, 4), torch.zeros(10, 4)
    assert fasttext.leaves((u, v), cfg)[0] is u
    with pytest.raises(ValueError, match="V \\+ 50"):
        fasttext.leaves((v, v), cfg)


def test_negative_probs_half_power():
    p = fasttext.negative_probs(np.array([4, 100, 25, 1]))
    w = np.sqrt([100.0, 25.0, 1.0])
    p0 = 2.0 / (2.0 + w.sum())
    assert p[0] == 0.0
    np.testing.assert_allclose(p[1:], w / (2.0 + w.sum()) + p0 / 3)


def test_work_counts_by_hand():
    B, W, D, K = 4, 1, 3, 2
    counts = np.array([10, 5, 5, 5, 5], dtype=np.int64)
    st = fasttext.Bound(hyper=None, offsets=None, ids=None,
                        n_sub=np.array([1, 4, 4, 10, 10]))
    shape = work.StepShape(B=B, W=W, D=D, K=K, n_negs=B * 2 * W * K,
                           fused=False, elt=4, counts=counts, sample=0.0,
                           model=fasttext, state=st)
    assert fasttext.mean_subwords(shape) == pytest.approx(7.0)
    # the rows 2 * 4 * 7 * 3 = 168; 8 pairs x 3 targets x 6D = 432; the
    # slab sums 8 x 3 = 24; the output adds (6 slab + 16 negatives) x 3
    assert shape.step_flops() == pytest.approx(168 + 432 + 24 + 66)
    assert shape.step_bytes() == pytest.approx(
        2.0 * (4 * 7.0 + shape.rows_all) * 3 * 4)
    ops, nbytes = ksub.per_step(shape)
    assert ops == pytest.approx(28 * 3 + 4 * 3)
    assert nbytes == pytest.approx(28 * (12 + 4) + 4 * 24 + 4 * 12)
    other = dataclasses.replace(shape, state=fasttext.hyper(_cfg()))
    assert ksub.per_step(other) is None


class _Ctx:
    def __init__(self, steps=4):
        self.trace, self.steps = None, steps


def test_subword_host_reader(monkeypatch):
    from benchmark import spans as S
    spans = [("epoch", 0.0, 10.0, -1), ("step", 1.0, 3.0, 0),
             ("step.subword", 1.0, 1.5, 1),
             ("step.subword_scatter", 2.0, 3.0, 1),
             ("step.scatter", 1.5, 2.0, 1)]
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    assert subword_host_us_per_step.read(_Ctx()) == pytest.approx(
        1.5 / 4 * 1e6)
    monkeypatch.setattr(S, "program_spans", lambda: spans[:2])
    assert subword_host_us_per_step.read(_Ctx()) is None


# set from CPU readings at this size (PERF.md §2 has the card's): the
# program's loss_gap 0, rows_gap ~1e-6, delta_gap ~1e-7; the control's
# and the faults' far above
LIMITS = dict(tiny.LIMITS, loss_gap=1e-5, rows_gap=0.01, delta_gap=1e-3)


def _tiny_cell() -> Cell:
    config = {"flags": ["-size", "16", "-window", "2", "-negative", "3",
                        "-min-count", "5", "-sample", "1e-3",
                        "-bitlevel", "1", "-model", "fasttext",
                        "-minn", "3", "-maxn", "6", "-bucket", "256"],
              "corpus": {"n_types": 400, "head": 3000, "s": 1.05,
                         "min_count": 5, "sentence": 20},
              "reference": "benchmark/fasttext.py"}
    wl = {"flags": ["-alpha", "0.05", "-batch-size", "64",
                    "-steps-per-chunk", "4", "-scatter-impl", "add"],
          "epoch_s": 0.1, "limits": dict(LIMITS)}
    return Cell(name="tiny.fasttext", workload=wl, config=config)


LAYER = ["subword_host_us_per_step.t", "step_idle_pct.t",
         "subword_roofline.t", "call_setup_s.t", "host_words_per_s.t"]


def _run(fault=None, trace=False):
    return run.run_cell(_tiny_cell(), SEED, 0.2, trace, "cpu",
                        ["setup_s"], LAYER, time.perf_counter(),
                        fault=fault, units={m: "u" for m in
                                            ["setup_s"] + LAYER})


def test_tiny_cell_is_correct():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["rows_gap"][0] < 1e-4
    assert "call_setup_s.t" in out["metrics"]
    assert "subword_host_us_per_step.t" in out["metrics"]
    for m in ("step_idle_pct.t", "subword_roofline.t"):
        assert m not in out["metrics"]        # no device on the CPU


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
    state = fasttext.bind(cfg, words, "cpu")
    return corpus, cfg, tap, r, state


def frozen_buckets(fn, V: int):
    """The program's chunk with the input table's bucket rows (V..) put
    back as they came in: the words' own rows and the output rows train,
    the n-grams do not."""
    def chunk(*args, **kwargs):
        keep = args[0][V:].clone()
        out = fn(*args, **kwargs)
        out[0][V:] = keep
        return out
    return chunk


@pytest.mark.parametrize("mode", ["control", "frozen_buckets"])
def test_tiny_cell_control_and_frozen_buckets_are_not_correct(mode):
    cell = _tiny_cell()
    corpus, cfg, tap, r, state = _window(cell)
    fn = tap.chunk_fn
    if mode == "frozen_buckets":
        fn = frozen_buckets(fn, corpus.size)
    got = check.step_readings(cell.model, cfg, fn, tap.engine.alias,
                              r.tables, corpus, SEED,
                              check.middle_scalars(tap.calls),
                              mode="program" if mode != "control"
                              else "control", state=state)
    lim = cell.workload["limits"]
    assert max(got[k] / lim[k]
               for k in ("rows_gap", "delta_gap", "loss_gap")) > 3


def test_frozen_buckets_fails_the_cell_s_limits():
    """At the fasttext cell's own limits, a step that leaves the bucket
    rows as they were reads `correct` false (the probe's 0.968)."""
    cell = _tiny_cell()
    limits = cells.load_cell("fasttext.subword-pair").workload["limits"]
    corpus, cfg, tap, r, state = _window(cell)
    got = check.step_readings(cell.model, cfg,
                              frozen_buckets(tap.chunk_fn, corpus.size),
                              tap.engine.alias, r.tables, corpus, SEED,
                              check.middle_scalars(tap.calls), state=state)
    step_limits = {k: limits[k] for k in ("loss_gap", "rows_gap",
                                          "delta_gap")}
    _, correct, failed = check.judge(step_limits, got)
    assert not correct and failed >= 1
    assert got["rows_gap"] > 0.5
