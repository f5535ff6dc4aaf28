"""The optional pieces of the model-module contract (benchmark/hooks.py):

- pinned: the tiny cells' readings (tiny.py's three CBOW cells and
  test_bench_skipgram.py's SGNS cell), recorded at the parent of the
  hooks (commit 4708560, on the CPU with torch 2.13.0, two threads), are
  read again bit for bit through the run's own path (the module's words,
  its `bind`, the state handed to the check);
- defaults: each default returns what the code it replaced returned on
  those cells (`corpus.word_names`, the u/v halves, the touched set,
  `plain.negative_probs`, `hyper`), and run.py reads each hook;
- a subword module (probe_subword.py: fastText's skip-gram in miniature,
  two leaves of different row counts, count^0.5 negatives) is checked
  and counted through the hooks: its own step reads every gap 0, a step
  that leaves the bucket rows unchanged reads far over the limits the
  skip-gram cell uses, and `sampler_tv` tells count^0.5 from count^0.75.
"""

import dataclasses
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from benchmark import check, hooks, plain, run, skipgram, work
from benchmark.cells import CONTRACT, HERE, Cell
from benchmark.corpus import make_corpus, word_names
from benchmark.tap import Tap
from benchmark.tests import probe_subword, tiny
from benchmark.tests.test_bench_skipgram import _tiny_cell

SEED = 2 ** 31 + 23
TV_DRAWS = 1 << 16     # the pinned sampler_tv's draws
STEP_KEYS = ("loss_gap", "rows_gap", "delta_gap")

# (program's loss_gap, rows_gap, delta_gap), the control's, sampler_tv
PINNED = {
    "capacity": ((6.918298560696412e-08, 0.01096801256695448,
                  0.0007066233307851198),
                 (0.0020792010690625674, 0.9452111070871075,
                  0.04063112962526126), 0.01835934913251578),
    "shipped": ((7.777002237832395e-08, 0.024077495583634086,
                 0.0011484365268439136),
                (0.001732871638633814, 1.1282355852511754,
                 0.06452277650015135), 0.01879684889155447),
    "split": ((0.0, 5.394474155900414e-06, 1.8877856115890504e-06),
              (0.00042688457793934145, 0.10339439087789778,
               0.007652579905359289), 0.01835934913251578),
    "sgns": ((1.363384881097841e-07, 5.694453406938045e-06,
              3.129639210328501e-07),
             (8.275746228263896e-05, 0.17860664600808468,
              0.00866697432171892), 0.01835934913251578),
}


def _cell(kind: str) -> Cell:
    return _tiny_cell() if kind == "sgns" else tiny.cell(kind)


def _window(cell):
    """One epoch of the program on the CPU under tap.py, its vocabulary
    from the module's words, as run.py makes it."""
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
    return cfg, corpus, words, tap, r


@pytest.mark.parametrize("kind", sorted(PINNED))
def test_tiny_cells_read_the_pinned_readings(kind, monkeypatch):
    cell = _cell(kind)
    cfg, corpus, words, tap, r = _window(cell)
    state = hooks.of(cell.model, "bind")(cfg, words, "cpu")
    for mode, want in zip(("program", "control"), PINNED[kind][:2]):
        got = check.step_readings(cell.model, cfg, tap.chunk_fn,
                                  tap.engine.alias,
                                  [t.clone() for t in r.tables], corpus,
                                  SEED, check.middle_scalars(tap.calls),
                                  mode=mode, state=state)
        assert tuple(got[k] for k in STEP_KEYS) == want, mode
    monkeypatch.setattr(check, "TV_DRAWS", TV_DRAWS)
    tv = check.sampler_tv(tap.engine.alias, corpus.counts, SEED,
                          probs=hooks.of(cell.model, "negative_probs"))
    assert tv == PINNED[kind][2]


@pytest.mark.parametrize("kind", ["capacity", "split", "sgns"])
def test_default_hooks_return_what_they_replaced(kind):
    cell = _cell(kind)
    model = cell.model
    assert not any(hasattr(model, k) for k in hooks.OPTIONAL)
    cfg, corpus, words, tap, r = _window(cell)
    D = cfg.size
    assert words == word_names(cell.config["corpus"]["n_types"])
    # the u/v halves (check._halves at the parent): views of the tables
    got = hooks.of(model, "leaves")(r.tables, cfg)
    if len(r.tables) == 1:
        want = [r.tables[0][:, :D], r.tables[0][:, D:]]
    else:
        want = list(r.tables[:2])
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.data_ptr() == w.data_ptr() and g.shape == w.shape
        assert g.stride() == w.stride() and torch.equal(g, w)
    # the touched set: the slab's tokens and the negatives, for both
    gen = torch.Generator().manual_seed(SEED)
    B, W = cfg.batch_size, cfg.window
    slab = torch.randint(-1, corpus.size, (B + 2 * W,), generator=gen)
    negs = plain.draw_negatives(gen, plain.negative_cdf(corpus.counts,
                                                        "cpu"),
                                model.negative_shape(cfg, 1)[1:])
    ids = torch.unique(torch.cat([slab.clamp_min(0), negs.reshape(-1)]))
    got = hooks.of(model, "touched")(model.hyper(cfg), slab, negs)
    assert len(got) == 2 and all(torch.equal(g, ids) for g in got)
    assert np.array_equal(hooks.of(model, "negative_probs")(corpus.counts),
                          plain.negative_probs(corpus.counts))
    assert hooks.of(model, "bind")(cfg, words, "cpu") == model.hyper(cfg)
    assert hooks.bound(model, cfg, "cpu", corpus.size) == model.hyper(cfg)


def test_run_reads_each_hook_of_the_cell_s_module(monkeypatch):
    """A module that gives every hook (skip-gram's defaults, each call
    recorded, and the subword probe's spelled words) reads the same
    checks as skipgram.py, which gives none; the program trains on the
    module's words."""
    from word2bits_tpu_torch import train as train_mod
    calls = []

    def recorded(name, fn):
        def hook(*args):
            calls.append(name)
            return fn(*args)
        return hook

    mod = types.SimpleNamespace(
        __name__="recording", **{k: getattr(skipgram, k) for k in CONTRACT},
        **{k: recorded(k, hooks.of(skipgram, k)) for k in hooks.OPTIONAL})
    mod.vocab_words = recorded("vocab_words", probe_subword.vocab_words)
    trained = []
    train = train_mod.train

    def train_recorded(cfg, vocab=None, **kw):
        trained.append(list(vocab.words))
        return train(cfg, vocab=vocab, **kw)

    monkeypatch.setattr(train_mod, "train", train_recorded)
    out = []
    for module in (skipgram, mod):
        cell = _tiny_cell()
        cell.model = module
        out.append(run.run_cell(cell, SEED, 0.2, False, "cpu", ["setup_s"],
                                [], time.perf_counter(),
                                units={"setup_s": "s"}))
    assert out[0]["correct"] and out[1]["correct"]
    assert out[1]["checks"] == out[0]["checks"]
    words = probe_subword.vocab_words(None, 400)
    assert trained[0] == word_names(400) and trained[-1] == words
    assert calls.count("vocab_words") == 1 and calls.count("bind") == 1
    # the three compared steps; the check's draws and the sampler (the
    # work counts read it where a metric reads their rows)
    assert calls.count("touched") == 3
    assert calls.count("negative_probs") == 2
    # before, after each compared step, and the rows read around it
    assert calls.count("leaves") >= 1 + 3 * 4


def test_rows_gap_takes_the_worst_of_n_leaves_over_their_median():
    f32 = torch.float32
    ids = [torch.tensor([0, 1]), torch.tensor([3]), torch.tensor([2, 5])]
    zero = [torch.zeros(2, 2), torch.zeros(1, 3), torch.zeros(2, 1)]
    start = plain.Rows.of(list(zip(ids, zero)), f32)
    # the reference moves each leaf by 1, 2 and 4 (median 2)
    moved = [torch.full((2, 2), 0.5), torch.full((1, 3), 2 / 3 ** 0.5),
             torch.full((2, 1), 8 ** 0.5)]
    ref = plain.Rows.of(list(zip(ids, moved)), f32)
    assert plain.rows_gap(ref, ref, start) == 0.0
    # the program misses leaf 0 (1 over the median 2) and leaf 2 (1 of 4)
    prog = plain.Rows.of([(ids[0], zero[0]), (ids[1], moved[1]),
                          (ids[2], moved[2] * (1 - 0.25))], f32)
    assert plain.rows_gap(prog, ref, start) == pytest.approx(0.5)
    assert check._row_norms(ref, start) == pytest.approx([1.0, 2.0, 4.0])
    assert torch.equal(ref.find(2, torch.tensor([5, 2])),
                       torch.tensor([1, 0]))


# -- a subword module -------------------------------------------------------

def _subword_cell() -> Cell:
    config = {"flags": ["-size", "16", "-window", "2", "-negative", "3",
                        "-min-count", "5", "-sample", "1e-3",
                        "-bitlevel", "0", "-model", "skipgram",
                        "-neg-per-pair", "1"],
              "corpus": {"n_types": 400, "head": 3000, "s": 1.05,
                         "min_count": 5, "sentence": 20},
              "reference": "benchmark/tests/probe_subword.py"}
    wl = {"flags": ["-batch-size", "64", "-steps-per-chunk", "4",
                    "-scatter-impl", "add"], "epoch_s": 0.1}
    return Cell(name="tiny.subword", workload=wl, config=config)


def _sgns_limits() -> dict:
    with open(os.path.join(HERE, "workloads", "sgns.pair-add.json")) as f:
        return json.load(f)["limits"]


def _subword_readings(fault=None):
    """The check's step readings of a program whose chunk is the probe's
    own step; `fault` "buckets" leaves the bucket rows as they were."""
    cell = _subword_cell()
    model = cell.model
    cfg = cell.cfg(SEED)
    corpus = make_corpus(cell.config["corpus"], SEED, "cpu")
    words = model.vocab_words(cell.config["corpus"], corpus.size)
    state = model.bind(cfg, words, "cpu")
    B, W, D, V = cfg.batch_size, cfg.window, cfg.size, corpus.size
    gen = torch.Generator().manual_seed(SEED)
    inp = (torch.rand((V + probe_subword.BUCKETS, D), generator=gen)
           - 0.5) / D
    out = (torch.rand((V, D), generator=gen) - 0.5) / D

    def chunk(inp, out, tokens, sents, alias, sc, gen, n_steps, shrinks,
              negs):
        assert tuple(negs.shape) == model.negative_shape(cfg, n_steps)
        loss = 0.0
        for s in range(n_steps):
            lo = sc.base0 + s * B
            t = tokens[lo - W:lo + B + W].long()
            ids = model.touched(state, t, negs[s])
            rows = plain.Rows.of([(ids[0], inp[ids[0]]),
                                  (ids[1], out[ids[1]])], inp.dtype)
            alpha = plain.step_alpha(sc.alpha0,
                                     sc.wca_start + s * sc.wca_per_step,
                                     sc.denom)
            loss += float(model.step(rows, t, sents[lo - W:lo + B + W]
                                     .long(), shrinks[s], negs[s], alpha,
                                     state))
            keep = ids[0] < V if fault == "buckets" else slice(None)
            inp[ids[0][keep]] = rows.leaves[0][keep]
            out[ids[1]] = rows.leaves[1]
        return inp, out, torch.tensor(loss)

    scalars = (W, 0.05, 0.0, float(B), 1e6)
    return check.step_readings(model, cfg, chunk, None, [inp, out], corpus,
                               SEED, scalars, state=state)


def test_subword_module_loads_and_binds_its_words():
    cell = _subword_cell()
    assert cell.model is probe_subword
    words = probe_subword.vocab_words(cell.config["corpus"], 400)
    assert words[0] == "</s>" and len(set(words)) == 400
    assert words[1:3] == ["ka", "ri"] and words[9] == "kaka"
    state = probe_subword.bind(cell.cfg(SEED), words, "cpu")
    V, nb = 400, probe_subword.BUCKETS
    # fastText's hash (FNV-1a, 32 bits) on its published test vectors
    assert [probe_subword.fnv1a(b) for b in (b"", b"a", b"foobar")] == \
        [0x811C9DC5, 0xE40C292C, 0xBF9CF968]
    # "ka": its row, then "<ka", "<ka>", "ka>"
    g = state.ids[state.offsets[1]:state.offsets[2]].tolist()
    assert g == [1] + [V + probe_subword.fnv1a(x) % nb
                       for x in (b"<ka", b"<ka>", b"ka>")]
    assert state.n_sub[0] == 1 and state.n_sub[1] == 4
    assert int(state.offsets[-1]) == state.n_sub.sum() == state.ids.numel()
    grams = state.ids[state.ids >= V]
    assert int(grams.max()) < V + nb and grams.numel() > nb
    assert torch.unique(grams).numel() < grams.numel()   # shared n-grams


def test_subword_module_reads_every_gap_zero():
    got = _subword_readings()
    assert got["loss_gap"] == 0.0 and got["rows_gap"] == 0.0
    assert got["delta_gap"] < 1e-6
    # each leaf moved: the input rows (words and buckets), the output rows
    for prog, ref in got["leaf_norms"]:
        assert len(ref) == 2 and min(ref) > 0


def test_subword_module_fault_leaving_the_buckets_reads_over_the_limits():
    lim = _sgns_limits()
    got = _subword_readings(fault="buckets")
    assert got["rows_gap"] >= 10 * lim["rows_gap"]
    assert got["delta_gap"] >= 10 * lim["delta_gap"]
    checks, correct, failed = check.judge(
        {k: lim[k] for k in STEP_KEYS}, got)
    assert not correct and failed >= 2


def test_subword_module_refuses_the_default_words():
    cell = _subword_cell()
    corpus = make_corpus(cell.config["corpus"], SEED, "cpu")
    with pytest.raises(ValueError, match="vocab_words"):
        check.step_readings(cell.model, cell.cfg(SEED), None, None,
                            [torch.zeros(1, 1)], corpus, SEED,
                            (2, 0.05, 0.0, 64.0, 1e6))
    with pytest.raises(ValueError, match="vocab_words"):
        work.StepShape.of(cell.cfg(SEED), corpus.counts, cell.model)


def test_sampler_tv_reads_the_module_s_distribution():
    """Draws from count^0.5 pass the skip-gram cell's limit against the
    subword module's distribution; draws from count^0.75 do not."""
    counts = make_corpus(_subword_cell().config["corpus"], SEED,
                         "cpu").counts
    alias = types.SimpleNamespace(prob=torch.zeros(1))

    def draws(probs):
        cdf = plain.negative_cdf(counts, "cpu", probs)
        return lambda gen, atab, shape, V: plain.draw_negatives(gen, cdf,
                                                                shape)

    probs = hooks.of(probe_subword, "negative_probs")
    half = check.sampler_tv(alias, counts, SEED,
                            draw=draws(probe_subword.negative_probs),
                            probs=probs)
    three_quarters = check.sampler_tv(alias, counts, SEED,
                                      draw=draws(plain.negative_probs),
                                      probs=probs)
    lim = _sgns_limits()["sampler_tv"]
    assert half < lim / 2
    assert three_quarters > 5 * lim


def test_subword_work_counts_read_the_bound_words():
    cell = _subword_cell()
    cfg = cell.cfg(SEED)
    counts = make_corpus(cell.config["corpus"], SEED, "cpu").counts
    words = probe_subword.vocab_words(cell.config["corpus"], len(counts))
    state = probe_subword.bind(cfg, words, "cpu")
    sh = work.StepShape.of(cfg, counts, cell.model, state)
    assert sh.state is state
    assert sh.n_negs == cfg.batch_size * 2 * cfg.window * cfg.negative
    assert np.array_equal(sh.p_neg, probe_subword.negative_probs(counts))
    B, W, D, K = cfg.batch_size, cfg.window, cfg.size, cfg.negative
    g = float((sh.p_kept * state.n_sub).sum())
    assert 4 < g < 20
    assert sh.step_flops() == 2.0 * B * g * D + 7.0 * B * 2 * W * (K + 1) * D
    # longer words, more subword rows: more work from the same flags
    longer = probe_subword.bind(cfg, [words[0]] + [w + w for w in words[1:]],
                                "cpu")
    sh2 = work.StepShape.of(cfg, counts, cell.model, longer)
    assert sh2.step_flops() > sh.step_flops()
    assert sh2.step_bytes() > sh.step_bytes()
    # the negatives' rows follow count^0.5, not count^0.75
    sgns = work.StepShape.of(cfg, counts, skipgram)
    assert sgns.n_negs == sh.n_negs and sgns.rows_all < sh.rows_all
