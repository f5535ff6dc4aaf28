"""The per-model contract: a configuration's `reference` key names its
model module, and the check and the work counts take everything
model-specific from it.

- golden: the CBOW module gives the numbers that the harness gave before
  the contract (commit 8b575bb, recorded on the CPU with torch 2.13.0):
  the tiny cells' step readings exactly, the real configurations' work
  counts exactly and their expected-row sums to a relative 1e-12;
- dispatch: a probe module (probe_model.py) is checked and counted through,
  and load_cell refuses, naming `reference`, a module that does not follow
  the cell's -model, one that lacks a piece of the contract, and a path
  outside benchmark/;
- run.py gives no result where a model module loads JAX in the check;
- calibrate.py reads a fault that the cell's engine cannot have as "n/a".
"""

import contextlib
import dataclasses
import io
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import calibrate, cells, check, plain, reference, run, work
from benchmark.corpus import make_corpus, word_names, zipf_counts
from benchmark.kernels import context, group_rmw, span_scatter
from benchmark.tap import Tap
from benchmark.tests import probe_model, tiny

SEED = 2 ** 31 + 7

PARENT_GAPS = {
    ("capacity", "program"): {
        "loss_gap": 7.882488492157988e-08,
        "rows_gap": 0.02012582652116717,
        "delta_gap": 0.0009786391293018014,
        "step_loss_gaps": [7.882488492157988e-08, 7.477025157871779e-08,
                           0.0],
        "step_rows_gaps": [0.014246895974090252, 0.02012582652116717,
                           0.012183372320187288],
        "step_delta_gaps": [0.0006139359030289611, 0.0006673299816741736,
                            0.0009786391293018014]},
    ("capacity", "control"): {
        "loss_gap": 0.0029581402813370497,
        "rows_gap": 1.061848239557065,
        "delta_gap": 0.06057056904950359,
        "step_loss_gaps": [0.0029581402813370497, 0.0029088853074278865,
                           8.206625859927046e-06],
        "step_rows_gaps": [0.799995260513432, 1.061848239557065,
                           0.9926284643675594],
        "step_delta_gaps": [0.06057056904950359, 0.044437488872268074,
                            0.013864409153596189]},
    ("shipped", "program"): {
        "loss_gap": 7.603199943553844e-08,
        "rows_gap": 0.026987873025443587,
        "delta_gap": 0.0017749734117852554,
        "step_loss_gaps": [0.0, 7.603199943553844e-08,
                           7.438321069773385e-08],
        "step_rows_gaps": [0.02674231617727159, 0.014897599211986285,
                           0.026987873025443587],
        "step_delta_gaps": [0.00044657034069595276, 0.0003480346942278264,
                            0.0017749734117852554]},
    ("shipped", "control"): {
        "loss_gap": 0.004498775396375493,
        "rows_gap": 1.49441124378869,
        "delta_gap": 0.10754922440497179,
        "step_loss_gaps": [0.00014321583098792295, 0.002274218599865236,
                           0.004498775396375493],
        "step_rows_gaps": [1.4877284403533888, 1.49441124378869,
                           1.162977674700199],
        "step_delta_gaps": [0.013606098953884942, 0.10754922440497179,
                            0.019260025563974804]},
}

# exact: counts; to a relative 1e-12: sums of expected rows
PARENT_WORK = {
    "wiki.capacity-grmw": {
        "n_negs": 6144, "step_flops": 2421580800.0,
        "step_bytes": 111794243.02134076,
        "rows_slab": 14500.28988343635, "rows_v": 20435.41106073264,
        "rows_all": 20449.131946704583,
        "context": (498073600.0, 229310472),
        "group_rmw": (36070400, 275516760.45890933),
        "span_scatter": (36070400, 275426580.45890933)},
    "text8.shipped-span": {
        "n_negs": 6144, "step_flops": 303929600.0,
        "step_bytes": 10580492.272961084,
        "rows_slab": 4705.21003106619, "rows_v": 8520.405310135166,
        "rows_all": 8526.718310580836,
        "context": (62259200.0, 35397640),
        "group_rmw": (5740800, 36835593.29692934),
        "span_scatter": (5740800, 36778181.29692934)},
}
ROW_SUMS = ("step_bytes", "rows_slab", "rows_v", "rows_all")


def _window(cell):
    """One epoch of the program on the CPU under tap.py."""
    from word2bits_tpu_torch import train
    from word2bits_tpu_torch.data.vocab import Vocab
    corpus = make_corpus(cell.config["corpus"], SEED, "cpu")
    vocab = Vocab(words=word_names(corpus.size), counts=corpus.counts)
    cfg = dataclasses.replace(cell.cfg(SEED), iter=1)
    tap = Tap(batch=cfg.batch_size)
    with tap:
        r = train.train(cfg, vocab=vocab, encoded=corpus.encoded,
                        device="cpu")
    return cfg, corpus, tap, r


@pytest.mark.parametrize("kind", ["capacity", "shipped"])
def test_tiny_cells_read_the_parent_gaps(kind):
    cell = tiny.cell(kind)
    assert cell.model is reference
    cfg, corpus, tap, r = _window(cell)
    for mode in ("program", "control"):
        got = check.step_readings(cell.model, cfg, tap.chunk_fn,
                                  tap.engine.alias,
                                  [t.clone() for t in r.tables], corpus,
                                  SEED, check.middle_scalars(tap.calls),
                                  mode=mode)
        want = PARENT_GAPS[(kind, mode)]
        assert {k: got[k] for k in want} == want, mode


def _counts(spec) -> np.ndarray:
    """make_corpus's counts, without the corpus: `</s>` first."""
    c = zipf_counts(spec["n_types"], spec["head"], spec["s"],
                    spec["min_count"])
    n_sent = int(c.sum()) // spec["sentence"] if spec["sentence"] else 0
    return np.concatenate([[n_sent], c]).astype(np.int64)


@pytest.mark.parametrize("name", sorted(PARENT_WORK))
def test_real_configurations_count_the_parent_work(name):
    cell = cells.load_cell(name)
    assert cell.model is reference
    sh = work.StepShape.of(cell.cfg(SEED), _counts(cell.config["corpus"]),
                           cell.model)
    want = PARENT_WORK[name]
    got = {"n_negs": sh.n_negs, "step_flops": sh.step_flops(),
           "step_bytes": sh.step_bytes(), "rows_slab": sh.rows_slab,
           "rows_v": sh.rows_v, "rows_all": sh.rows_all}
    for k in got:
        if k in ROW_SUMS:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
        else:
            assert got[k] == want[k], k
    for kernel in (context, group_rmw, span_scatter):
        flops, nbytes = kernel.per_step(sh)
        w_flops, w_bytes = want[kernel.__name__.rsplit(".", 1)[1]]
        assert flops == w_flops
        if kernel is context:
            assert nbytes == w_bytes
        else:
            assert nbytes == pytest.approx(w_bytes, rel=1e-12, abs=0)


# -- dispatch ---------------------------------------------------------------

SPLIT = tiny.cell("split")


def _files(tmp_path, monkeypatch, flags, reference_path, name="t.probe"):
    """A cell's workload and configuration files where load_cell reads
    them (tiny flags, the given -model flags and `reference`)."""
    (tmp_path / "workloads").mkdir()
    (tmp_path / "configs").mkdir()
    config = dict(SPLIT.config, name="probe-config", flags=flags,
                  reference=reference_path)
    workload = dict(SPLIT.workload, config="probe-config",
                    flags=list(SPLIT.workload["flags"])
                    + ["-neg-sharing", "16"])
    (tmp_path / "configs" / "probe-config.json").write_text(
        json.dumps(config))
    (tmp_path / "workloads" / f"{name}.json").write_text(
        json.dumps(workload))
    monkeypatch.setattr(cells, "HERE", str(tmp_path))
    return name


def _plain_chunk(model, cfg):
    """A program whose chunk is `model`'s own plain step, step by step,
    on split tables: the chunk callable the check drives, which takes the
    negatives in the model's shape."""
    hp = model.hyper(cfg)
    B, W = cfg.batch_size, cfg.window

    def chunk(u, v, tokens, sents, alias, sc, gen, n_steps, shrinks, negs):
        assert tuple(negs.shape) == model.negative_shape(cfg, n_steps)
        loss = 0.0
        for s in range(n_steps):
            lo = sc.base0 + s * B
            t = tokens[lo - W:lo + B + W].long()
            ids = torch.unique(torch.cat([t.clamp_min(0),
                                          negs[s].reshape(-1)]))
            rows = plain.Rows(ids, u[ids], v[ids], u.dtype)
            alpha = plain.step_alpha(sc.alpha0,
                                     sc.wca_start + s * sc.wca_per_step,
                                     sc.denom)
            loss += float(model.step(rows, t, sents[lo - W:lo + B + W]
                                     .long(), shrinks[s], negs[s], alpha,
                                     hp))
            u[ids], v[ids] = rows.u, rows.v
        return u, v, torch.tensor(loss)

    return chunk


def test_probe_module_is_checked_and_counted_through(tmp_path, monkeypatch):
    name = _files(tmp_path, monkeypatch, SPLIT.config["flags"],
                  "benchmark/tests/probe_model.py")
    cell = cells.load_cell(name)
    assert cell.model is probe_model
    cfg = cell.cfg(SEED)
    B, S, K, D = cfg.batch_size, cfg.steps_per_chunk, cfg.negative, cfg.size
    corpus = make_corpus(cell.config["corpus"], SEED, "cpu")
    # counted: the probe's negatives (one set a center, not a tile's) and
    # its marker
    sh = work.StepShape.of(cfg, corpus.counts, cell.model)
    cbow = work.StepShape.of(cfg, corpus.counts, reference)
    assert sh.n_negs == B * K and cbow.n_negs == (B // 16) * K
    assert sh.step_flops() == reference.step_flops(sh) + probe_model.MARKER
    assert sh.step_bytes() == reference.step_bytes(sh) + probe_model.MARKER
    assert sh.rows_v > cbow.rows_v
    assert span_scatter.per_step(sh) != span_scatter.per_step(cbow)
    # checked: the chunk and the reference both take the probe's shape
    gen = torch.Generator().manual_seed(SEED)
    u = (torch.rand((corpus.size, D), generator=gen) - 0.5) / D
    v = torch.rand((corpus.size, D), generator=gen) - 0.5
    scalars = (cfg.window, 0.025, 0.0, float(B), 1e6)
    got = check.step_readings(cell.model, cfg, _plain_chunk(cell.model, cfg),
                              None, [u, v], corpus, SEED, scalars)
    assert got["steps"] == check.compared_steps(S)
    assert got["loss_gap"] == 0.0 and got["rows_gap"] == 0.0
    assert got["delta_gap"] < 1e-6


@pytest.mark.parametrize("model_flags, path, words", [
    (["-model", "skipgram"], "benchmark/reference.py",
     ["follows -model cbow, not skipgram"]),
    (["-cbow", "0"], "benchmark/reference.py", ["not skipgram"]),
    ([], "benchmark/tests/probe_partial.py", ["lacks negative_shape"]),
    ([], "word2bits_tpu_torch/models/cbow.py", ["no .py file under"]),
    ([], "benchmark/../word2bits_tpu_torch/models/cbow.py",
     ["no .py file under"]),
    ([], "benchmark/nothing_here.py", ["no such file"]),
], ids=["skipgram", "cbow0", "partial", "outside", "dotdot", "missing"])
def test_load_cell_refuses_a_module_off_the_contract(tmp_path, monkeypatch,
                                                     model_flags, path,
                                                     words):
    name = _files(tmp_path, monkeypatch,
                  SPLIT.config["flags"] + model_flags, path)
    with pytest.raises(ValueError) as err:
        cells.load_cell(name)
    msg = str(err.value)
    assert "configuration probe-config: `reference`" in msg
    assert path in msg
    for w in words:
        assert w in msg


def test_no_run_starts_on_a_module_off_the_contract(tmp_path, monkeypatch,
                                                    capsys):
    # run.main sets these for the run; the test gives them back
    for k in ("OMP_NUM_THREADS", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
              "USE_FLAX"):
        monkeypatch.setenv(k, os.environ.get(k, ""))
    name = _files(tmp_path, monkeypatch,
                  SPLIT.config["flags"] + ["-model", "skipgram"],
                  "benchmark/reference.py")
    with pytest.raises(ValueError, match="`reference`"):
        run.main(["--workload", name, "--seed", str(SEED), "--seconds", "1",
                  "--trace", "0"])
    assert capsys.readouterr().out == ""


def _main_on_cpu(monkeypatch, name):
    """run.main for cell `name`, its look for a card passed and the run
    itself on the CPU; (exit code, standard output)."""
    for k in ("OMP_NUM_THREADS", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
              "USE_FLAX"):
        monkeypatch.setenv(k, os.environ.get(k, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    run_cell = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda cell, seed, seconds, trace,
                        device, *a, **kw: run_cell(cell, seed, seconds,
                                                   trace, "cpu", *a, **kw))
    threads = torch.get_num_threads()
    # whatever an earlier test loaded of them is put back afterwards
    loaded = {k: m for k, m in sys.modules.items()
              if k.split(".")[0] in run.FORBIDDEN}
    for k in loaded:
        del sys.modules[k]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", name, "--seed", str(SEED),
                           "--seconds", "0.2", "--trace", "0"])
    finally:
        for k in [k for k in sys.modules
                  if k.split(".")[0] in run.FORBIDDEN]:
            del sys.modules[k]
        sys.modules.update(loaded)
        torch.set_num_threads(threads)
    return rc, out.getvalue()


@pytest.mark.parametrize("module, rc", [
    ("benchmark/reference.py", 0), ("benchmark/tests/probe_jax.py", 3)],
    ids=["cbow", "loads-jax"])
def test_no_result_where_the_model_module_loads_jax(tmp_path, monkeypatch,
                                                    module, rc):
    """The look for JAX follows the check: a model module whose step loads
    it (probe_jax.py) leaves no result, where CBOW's gives one."""
    name = _files(tmp_path, monkeypatch, SPLIT.config["flags"], module)
    got, out = _main_on_cpu(monkeypatch, name)
    assert got == rc
    if rc:
        assert out == ""
    else:
        assert json.loads(out.strip().splitlines()[-1])["correct"] is True


# -- faults an engine cannot have ---------------------------------------------

@pytest.mark.parametrize("kind, want", [
    ("split", "n/a"), ("capacity", False), ("shipped", False)])
def test_calibrate_reads_plan0_as_na_where_it_cannot_be_planted(kind, want):
    t0 = time.perf_counter()
    lines = list(calibrate.seed_lines(tiny.cell(kind), SEED,
                                      ["program", "plan0"], "cpu"))
    assert [ln["mode"] for ln in lines] == ["program", "plan0"]
    assert lines[0]["correct"] is True
    assert lines[1]["correct"] == want
    if want == "n/a":
        assert "scatter_plan" in lines[1]["why"]
        assert "rows_gap" not in lines[1]
    else:
        assert lines[1]["over"]
    assert time.perf_counter() - t0 < 120
