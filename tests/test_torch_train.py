"""The port's config, CLI and training slice on the CPU, and its import rule.

The same argv resolves to equal fields in both packages (and the same
warnings); every flag the port has no code for is rejected by name; `cli
train` with W2B_FORCE_CPU=1 trains the fused engine on the verify corpus
(epoch losses trend less negative, the JAX reader reads the output,
bitlevel-1 rows are +-1/3), and so does `train.train` with each update
route (-hot-rows, -neg-stratify, -neg-dense-hot, -rmw-scatter,
-dedup-block); the public functions default to the card; and importing
every port module pulls in neither JAX nor the JAX package.
"""

import contextlib
import dataclasses
import io
import json
import os
import warnings
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from word2bits_tpu import config as jconfig
from word2bits_tpu.io.vectors import read_vectors as jread
from word2bits_tpu_torch import cli
from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain

REPO = Path(__file__).resolve().parent.parent
SHIPPED = ["-bitlevel", "1", "-size", "200", "-window", "8", "-negative",
           "24", "-min-count", "5", "-sample", "1e-3", "-alpha", "0.1",
           "-batch-size", "8192", "-steps-per-chunk", "256",
           "-fused-tables", "1", "-neg-sharing", "64", "-neg-pool", "2",
           "-dtype", "bfloat16", "-banded-tile", "256",
           "-scatter-impl", "span", "-context-pallas", "1"]
FUSED_ADD = ["-fused-tables", "1", "-neg-sharing", "8", "-banded-tile", "16"]
# the capacity configuration (docs/large_vocab.md:19-25)
FLAGSHIP = ["-output", "1b800d_full.pack", "-packed", "1", "-size", "800",
            "-window", "8", "-negative", "24", "-iter", "5", "-min-count",
            "5", "-bitlevel", "1", "-dtype", "bfloat16", "-fused-tables", "1",
            "-neg-sharing", "64", "-batch-size", "16384",
            "-steps-per-chunk", "32", "-loop-mode", "fori",
            "-scatter-impl", "grmw", "-banded-tile", "256",
            "-context-pallas", "1"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the training runs here are many tiny ops,
    which several test workers' thread pools on one machine slow a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the README Quick start (the reference-default slab engine)
QUICKSTART = ["-size", "200", "-window", "8", "-negative", "24", "-iter", "5",
              "-min-count", "5", "-bitlevel", "1", "-binary", "1"]


@pytest.mark.parametrize("argv", [
    [],
    SHIPPED,
    SHIPPED + ["-train", "c.txt", "-output", "v.bin", "-binary", "1",
               "-save-vocab", "voc.txt", "-iter", "3", "-seed", "9"],
    ["-bitlevel", "2", "-alpha", "0.05", "-span-window", "256"],
    ["-bitlevel", "8", "-auto-lr", "1", "-cbow", "1", "-threads", "4"],
    ["-bitlevel", "4", "-auto-lr", "0", "-reg", "0.01", "-bogus", "x"],
    FLAGSHIP,
    FUSED_ADD + ["-loop-mode", "unroll", "-scatter-impl", "grmw",
                 "-span-chunk", "64"],
    QUICKSTART,
    FUSED_ADD + ["-use-pallas", "1"],
    ["-fused-tables", "0", "-neg-sharing", "8", "-neg-pool", "2",
     "-use-pallas", "1", "-banded-tile", "0"],
    ["-batch-size", "4096", "-steps-per-chunk", "128", "-banded-tile", "256",
     "-scatter-impl", "span", "-context-pallas", "1"],
    # the update routes (rejected by name before they were ported)
    FUSED_ADD + ["-hot-rows", "100"],
    FUSED_ADD + ["-hot-rows", "100", "-hot-pallas", "1"],
    FUSED_ADD + ["-hot-rows", "100", "-neg-stratify", "1"],
    FUSED_ADD + ["-hot-rows", "100", "-neg-dense-hot", "1"],
    FUSED_ADD + ["-rmw-scatter", "1", "-steps-per-chunk", "1"],
    FUSED_ADD + ["-dedup-block", "64"],
    FUSED_ADD + ["-rmw-scatter", "1", "-loop-mode", "fori"],
    FUSED_ADD + ["-dedup-block", "64", "-loop-mode", "unroll"],
    ["-dedup-block", "64"],
    FUSED_ADD + ["-hot-rows", "2048", "-neg-dense-hot", "1",
                 "-device-epoch", "0"],
])
def test_config_same_fields_as_jax(argv):
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # none of these warns
        t = tconfig.config_from_argv(argv)
        j = jconfig.config_from_argv(argv)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.lr_scale, t.effective_alpha) == (j.lr_scale, j.effective_alpha)
    assert t.device_epoch_on == j.device_epoch_on


@pytest.mark.parametrize("argv,match", [
    (FUSED_ADD + ["-hot-rows", "100", "-neg-dense-hot", "1", "-bitlevel",
                  "4"], "neg-dense-hot"),
    (FUSED_ADD + ["-rmw-scatter", "1"], "rmw_scatter"),
])
def test_config_warns_as_jax(argv, match):
    """The JAX package's two configuration warnings: -neg-dense-hot at
    bitlevel >= 4, and -rmw-scatter with the scan loop over several steps
    (the default -steps-per-chunk 256)."""
    with pytest.warns(UserWarning, match=match):
        j = jconfig.config_from_argv(argv)
    with pytest.warns(UserWarning, match=match):
        t = tconfig.config_from_argv(argv)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("argv,on", [
    (FUSED_ADD, True),
    (FUSED_ADD + ["-hot-rows", "100"], False),
    (FUSED_ADD + ["-hot-rows", "100", "-neg-stratify", "1"], False),
    (FUSED_ADD + ["-hot-rows", "100", "-neg-dense-hot", "1"], True),
    (FUSED_ADD + ["-hot-rows", "100", "-neg-dense-hot", "1",
                  "-device-epoch", "0"], False),
])
def test_device_epoch_on_decides_the_cold_map(argv, on):
    """device_epoch_on resolves as the JAX package's, and the engine builds
    the cold map iff -hot-rows and not device_epoch_on: under the auto
    -device-epoch, -neg-dense-hot keeps the plain slab scatter."""
    cfg = tconfig.config_from_argv(argv)
    assert cfg.device_epoch_on == jconfig.config_from_argv(
        argv).device_epoch_on == on
    from word2bits_tpu_torch.data.vocab import Vocab
    from word2bits_tpu_torch.models.cbow import CBOWHyper
    vocab = Vocab(words=[f"w{i}" for i in range(300)],
                  counts=np.arange(300, 0, -1, dtype=np.int64))
    tables = ttrain.init_tables(cfg, vocab.size, "cpu")
    eng = ttrain.build_engine(cfg, vocab, tables, CBOWHyper(
        bitlevel=1, size=cfg.size, window=cfg.window,
        negative=cfg.negative))
    assert eng.cold_split == bool(cfg.hot_rows and not on)


@pytest.mark.parametrize("argv", [
    ["-bitlevel", "3"],
    ["-fused-tables", "1"],
    ["-neg-sharing", "3", "-batch-size", "64"],
    ["-neg-pool", "3", "-neg-sharing", "64", "-batch-size", "8192"],
    ["-context-pallas", "1", "-fused-tables", "1", "-neg-sharing", "8"],
    ["-scatter-impl", "sweep"],
    ["-scatter-impl", "span", "-span-window", "100"],
    ["-size", "0"],
])
def test_config_rejects_what_jax_rejects(argv):
    with pytest.raises(ValueError):
        jconfig.config_from_argv(argv)
    with pytest.raises(ValueError):
        tconfig.config_from_argv(argv)


@pytest.mark.parametrize("flag,argv", [
    ("-dtype", ["-dtype", "float16"]),
])
def test_unported_flags_rejected_by_name(flag, argv):
    jconfig.config_from_argv(argv)       # a valid configuration for JAX
    with pytest.raises(ValueError, match=re.escape(flag)):
        tconfig.config_from_argv(argv)


@pytest.mark.parametrize("argv", [
    FUSED_ADD + ["-scatter-impl", "grmw", "-checkpoint-dir", "ckpt"],
    ["-checkpoint-dir", "ckpt"],
    ["-resume", "1"],
    FUSED_ADD + ["-packed", "1", "-resume", "1"],
])
def test_formerly_unported_checkpoint_flags_train_on_cpu(tmp_path, argv):
    """The checkpoint and resume flags (rejected by name before they were
    ported) train a few steps; with -checkpoint-dir the run writes
    state.npz and a -resume 1 run continues from it at the next epoch;
    -resume 1 without a checkpoint starts from the initialization."""
    (tmp_path / "c.txt").write_text("a b c d e f a b c d\n" * 40)
    argv = [str(tmp_path / a) if a == "ckpt" else a for a in argv]
    base = ["-train", str(tmp_path / "c.txt"), "-min-count", "1", "-debug",
            "0", "-size", "8", "-batch-size", "32", "-steps-per-chunk", "4",
            "-output", str(tmp_path / "v.bin")]
    jconfig.config_from_argv(argv)       # a valid configuration for JAX
    res = ttrain.train(tconfig.config_from_argv(argv + base + ["-iter", "1"]),
                       device="cpu")
    assert res.steps > 0 and np.isfinite(res.epoch_losses).all()
    ckpt = tmp_path / "ckpt" / "state.npz"
    assert ckpt.exists() == ("-checkpoint-dir" in argv)
    if ckpt.exists():
        cfg2 = tconfig.config_from_argv(argv + base + ["-iter", "2",
                                                       "-resume", "1"])
        resumed = ttrain.train(cfg2, device="cpu")
        assert "load" in resumed.seconds and len(resumed.epoch_losses) == 1
        assert ttrain.load_checkpoint(str(ckpt), cfg2, "cpu").epoch == 1
    else:
        assert "init" in res.seconds
    assert (tmp_path / "v.bin").exists()


@pytest.mark.parametrize("argv", [
    ["-model", "skipgram"],
    ["-cbow", "0", "-neg-sharing", "8", "-neg-pool", "2"],
    ["-model", "skipgram", "-hot-rows", "4", "-neg-dense-hot", "1",
     "-dtype", "bfloat16"],
    ["-device-epoch", "1"],
    ["-device-epoch", "1", "-segment-tokens", "150"],
    FUSED_ADD + ["-device-epoch", "1", "-hot-rows", "4", "-neg-dense-hot",
                 "1"],
    ["-profile-dir", "prof"],
    ["-model", "skipgram", "-profile-dir", "prof", "-device-epoch", "0"],
])
def test_formerly_unported_flags_train_on_cpu(tmp_path, argv):
    """Skip-gram (-model skipgram, -cbow 0), the device epoch
    (-device-epoch 1, also over several segments) and -profile-dir, each
    rejected by name before they were ported, train a few steps on the
    CPU: the tables move, the epoch is built where device_epoch_on says,
    and -profile-dir writes one Chrome trace of the first chunk."""
    (tmp_path / "c.txt").write_text("a b c d e f a b c d\n" * 40)
    argv = [str(tmp_path / a) if a == "prof" else a for a in argv]
    jcfg = jconfig.config_from_argv(argv)     # a valid configuration for JAX
    cfg = tconfig.config_from_argv(argv + ["-train", str(tmp_path / "c.txt"),
                                           "-min-count", "1", "-debug", "1",
                                           "-size", "8", "-batch-size", "32",
                                           "-steps-per-chunk", "4"])
    assert cfg.device_epoch_on == jcfg.device_epoch_on
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = ttrain.train(cfg, device="cpu", max_steps=8)
    assert res.steps == 8 and np.isfinite(res.epoch_losses).all()
    where = "device" if cfg.device_epoch_on else "host"
    assert f"Epochs built on the {where}" in log.getvalue()
    assert len(res.tables) == 2 or cfg.model == "cbow"
    u, v = ttrain.table_halves(res.tables)
    from word2bits_tpu_torch.models.init import init_params
    u0, v0 = init_params(res.vocab.size, 8, device="cpu",
                         dtype=getattr(torch, cfg.dtype))
    assert not torch.equal(u, u0) and not torch.equal(v, v0)
    if cfg.profile_dir:
        traces = os.listdir(cfg.profile_dir)
        assert len(traces) == 1 and traces[0].endswith(".json")


@pytest.mark.parametrize("argv", [
    [],                                               # the slab engine
    ["-fused-tables", "1", "-neg-sharing", "8"],      # banded 0
    ["-fused-tables", "1", "-neg-sharing", "8", "-use-pallas", "1"],
])
def test_formerly_unported_engines_train_on_cpu(tmp_path, argv):
    """The reference-default engine, the fused engine's shifted sums and
    its score-kernel path each train a few steps and move the tables."""
    (tmp_path / "c.txt").write_text("a b c d e f a b c d\n" * 40)
    cfg = tconfig.config_from_argv(argv + ["-train", str(tmp_path / "c.txt"),
                                           "-min-count", "1", "-debug", "0",
                                           "-size", "8", "-batch-size", "32",
                                           "-steps-per-chunk", "4"])
    res = ttrain.train(cfg, device="cpu", max_steps=8)
    assert res.steps == 8 and np.isfinite(res.epoch_losses).all()
    assert len(res.tables) == (1 if cfg.fused_tables else 2)
    u, v = ttrain.table_halves(res.tables)
    assert u.shape == v.shape == (res.vocab.size, 8)
    from word2bits_tpu_torch.models.init import init_params
    u0, v0 = init_params(res.vocab.size, 8, device="cpu")
    assert not torch.equal(u, u0) and not torch.equal(v, v0)


ROUTES = {
    "hot-rows": FUSED_ADD + ["-hot-rows", "6"],
    "hot-rows, hot-pallas": FUSED_ADD + ["-hot-rows", "6", "-hot-pallas",
                                         "1"],
    "neg-stratify": FUSED_ADD + ["-hot-rows", "6", "-neg-stratify", "1"],
    "neg-dense-hot": FUSED_ADD + ["-hot-rows", "6", "-neg-dense-hot", "1"],
    "neg-dense-hot, device-epoch 0": FUSED_ADD + [
        "-hot-rows", "6", "-neg-dense-hot", "1", "-device-epoch", "0"],
    "rmw-scatter": FUSED_ADD + ["-rmw-scatter", "1", "-steps-per-chunk",
                                "1", "-dtype", "bfloat16"],
    "dedup-block, fused": FUSED_ADD + ["-dedup-block", "64"],
    "dedup-block, slab": ["-dedup-block", "64"],
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_update_routes_train_on_cpu(tmp_path, route):
    """train.train with each update route on the verify corpus: the epoch
    loss moves up (less negative), and the vectors file holds the
    vocabulary's rows of +-1/3, read by the JAX package's reader."""
    corpus, out = tmp_path / "corpus.txt", tmp_path / "vecs.bin"
    _verify_corpus(corpus)
    argv = ROUTES[route]
    if "-steps-per-chunk" not in argv:
        argv = argv + ["-steps-per-chunk", "8"]
    cfg = tconfig.config_from_argv(argv + [
        "-train", str(corpus), "-output", str(out), "-size", "16",
        "-window", "3", "-negative", "5", "-iter", "2", "-min-count", "2",
        "-bitlevel", "1", "-binary", "1", "-batch-size", "128",
        "-debug", "0"])
    res = ttrain.train(cfg, device="cpu")
    assert len(res.epoch_losses) == 2 and np.isfinite(res.epoch_losses).all()
    assert res.epoch_losses[1] > res.epoch_losses[0], res.epoch_losses
    words, vecs = jread(str(out))
    assert words == res.vocab.words and vecs.shape == (res.vocab.size, 16)
    assert np.all(np.abs(vecs) == np.float32(1) / np.float32(3))


def test_dense_hot_needs_a_cold_stratum():
    """As the JAX package's train.build_engine: -neg-dense-hot with
    -hot-rows >= the vocabulary raises (no cold lanes to sample)."""
    from word2bits_tpu_torch.data.vocab import Vocab
    from word2bits_tpu_torch.models.cbow import CBOWHyper
    cfg = tconfig.config_from_argv(FUSED_ADD + ["-hot-rows", "50",
                                                "-neg-dense-hot", "1"])
    vocab = Vocab(words=[f"w{i}" for i in range(50)],
                  counts=np.arange(50, 0, -1, dtype=np.int64))
    tables = ttrain.init_tables(cfg, vocab.size, "cpu")
    with pytest.raises(ValueError, match="hot-rows < vocab"):
        ttrain.build_engine(cfg, vocab, tables, CBOWHyper(size=cfg.size))


def test_public_functions_default_to_the_card(monkeypatch):
    """init_params, init_fused_table, analogy_predictions and the device
    epoch's build_with_uniforms run on the card unless asked for the CPU:
    without one they raise the resolve_device error instead of dropping
    to the CPU."""
    from word2bits_tpu_torch.eval import analogy as TA
    from word2bits_tpu_torch.models.init import init_fused_table, init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qs = TA.AnalogyQuestions(sections=["s"], questions=[(0, "A", "B", "C",
                                                         "D")])
    from word2bits_tpu_torch.data.device_pipeline import \
        build_with_uniforms
    calls = (lambda: init_params(10, 4), lambda: init_fused_table(10, 4),
             lambda: TA.analogy_predictions(["a", "b", "c", "d"],
                                            np.eye(4, dtype=np.float32), qs),
             lambda: build_with_uniforms(8, 2, np.ones(4, np.int32),
                                         np.ones(2), np.zeros(4)))
    for call in calls:
        with pytest.raises(RuntimeError, match="W2B_FORCE_CPU"):
            call()
    assert init_params(10, 4, device="cpu")[0].device.type == "cpu"


def test_no_silent_cpu(monkeypatch):
    """Without a card the default device raises instead of dropping to
    the CPU; the CLI's W2B_FORCE_CPU=1 asks for the CPU explicitly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="W2B_FORCE_CPU"):
        ttrain.resolve_device(None)
    assert ttrain.resolve_device("cpu").type == "cpu"
    monkeypatch.delenv("W2B_FORCE_CPU", raising=False)
    assert cli._device() == "cuda"
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    assert cli._device() == "cpu"


def _verify_corpus(path):
    """The topic corpus of .claude/skills/verify/SKILL.md (surface 1)."""
    rng = np.random.default_rng(42)
    topics = [["cat", "dog", "pet", "fur", "paw", "tail"],
              ["sun", "moon", "star", "sky", "cloud", "rain"],
              ["red", "blue", "green", "color", "paint", "ink"],
              ["run", "walk", "jump", "move", "step", "go"]]
    fill = ["the", "a", "of", "and", "to", "in"]
    lines = [" ".join([fill[rng.integers(6)] if rng.random() < .3
                       else t[rng.integers(6)]
                       for _ in range(rng.integers(8, 16))])
             for t in (topics[rng.integers(4)] for _ in range(3000))]
    Path(path).write_text("\n".join(lines) + "\n")


def test_cli_train_slice_on_cpu(tmp_path, monkeypatch, capsys):
    corpus, out = tmp_path / "corpus.txt", tmp_path / "vecs.bin"
    _verify_corpus(corpus)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    argv = ["train", "-train", str(corpus), "-output", str(out),
            "-size", "32", "-window", "3", "-negative", "5", "-iter", "3",
            "-min-count", "2", "-bitlevel", "1", "-binary", "1",
            "-save-vocab", str(tmp_path / "vocab.txt"),
            "-batch-size", "128", "-steps-per-chunk", "16",
            "-fused-tables", "1", "-neg-sharing", "8", "-neg-pool", "2",
            "-dtype", "bfloat16", "-banded-tile", "16",
            "-scatter-impl", "span", "-context-pallas", "1", "-debug", "1"]
    monkeypatch.setattr(sys, "argv", ["word2bits_tpu_torch.cli"] + argv)
    assert cli.main() == 0
    log = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"Epoch Loss: (\S+)", log)]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] > losses[0], losses        # less negative
    assert re.search(r"Trained \d+ steps", log)
    words, vecs = jread(str(out))                # the JAX package's reader
    vocab = (tmp_path / "vocab.txt").read_text().split("\n")[:-1]
    assert words == [line.split()[0] for line in vocab]
    assert vecs.shape == (len(words), 32)
    assert np.all(np.abs(vecs) == np.float32(1) / np.float32(3))


@pytest.mark.parametrize("engine", [
    [],
    ["-fused-tables", "0", "-neg-sharing", "8", "-use-pallas", "1"],
    ["-fused-tables", "1", "-neg-sharing", "8", "-use-pallas", "1"],
    ["-fused-tables", "0", "-neg-sharing", "8", "-neg-pool", "2",
     "-use-pallas", "1"],
])
def test_cli_train_quickstart_flags_on_cpu(tmp_path, monkeypatch, capsys,
                                           engine):
    """The README Quick start's flags at a small size (no engine flag: the
    reference-default slab engine, per-center negatives), and the same
    with the score kernel's path on both engines: epoch losses become less
    negative, the JAX package's reader reads the vectors, the vocabulary
    is the saved one and every value is +-1/3."""
    corpus, out = tmp_path / "corpus.txt", tmp_path / "vecs.bin"
    _verify_corpus(corpus)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    assert cli.train_main([
        "-train", str(corpus), "-output", str(out), "-size", "32",
        "-window", "3", "-negative", "5", "-iter", "2", "-min-count", "2",
        "-bitlevel", "1", "-binary", "1", "-save-vocab",
        str(tmp_path / "vocab.txt"), "-debug", "1"] + engine) == 0
    log = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"Epoch Loss: (\S+)", log)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[-1] > losses[0], losses
    words, vecs = jread(str(out))
    vocab = (tmp_path / "vocab.txt").read_text().split("\n")[:-1]
    assert words == [line.split()[0] for line in vocab]
    assert vecs.shape == (len(words), 32)
    assert np.all(np.abs(vecs) == np.float32(1) / np.float32(3))


def test_cli_train_capacity_flags_then_accuracy(tmp_path, monkeypatch,
                                                capsys):
    """`cli train` with the capacity flags (-scatter-impl grmw -loop-mode
    fori -packed 1) writes the vectors and `.pack` (the same vectors,
    bit-packed), and `cli accuracy` on each prints the JAX package's
    evaluator transcript for that file."""
    from word2bits_tpu import cli as jcli
    from word2bits_tpu.io.packed import read_packed as jread_packed

    corpus, out = tmp_path / "corpus.txt", tmp_path / "vecs.bin"
    _verify_corpus(corpus)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    assert cli.train_main([
        "-train", str(corpus), "-output", str(out), "-size", "32",
        "-window", "3", "-negative", "5", "-iter", "2", "-min-count", "2",
        "-bitlevel", "1", "-binary", "1", "-batch-size", "128",
        "-steps-per-chunk", "4", "-fused-tables", "1", "-neg-sharing", "8",
        "-dtype", "bfloat16", "-banded-tile", "16", "-scatter-impl", "grmw",
        "-loop-mode", "fori", "-context-pallas", "1", "-packed", "1",
        "-debug", "1"]) == 0
    log = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"Epoch Loss: (\S+)", log)]
    assert len(losses) == 2 and losses[-1] > losses[0], losses
    assert re.search(r"Init: \d+ x 64 bfloat16 table", log)
    words, vecs = jread(str(out))
    pwords, pvecs, bl = jread_packed(str(out) + ".pack")
    assert (pwords, bl) == (words, 1)
    np.testing.assert_array_equal(pvecs, vecs)
    q = tmp_path / "q.txt"
    q.write_text(": s1\ncat dog sun moon\nsun moon cat dog\n"
                 ": s2\nred blue run walk\nrun walk red blue\n"
                 "cat dog oov moon\n")
    for path in (str(out), str(out) + ".pack"):
        outs = []
        for main in (cli.accuracy_main, jcli.accuracy_main):
            assert main([path, "0", "0", "-questions", str(q)]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert "Questions seen / total: 4 5" in outs[0]


def test_cli_vocab_only_without_output(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus.txt"
    _verify_corpus(corpus)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    assert cli.train_main(["-train", str(corpus), "-min-count", "2",
                           "-save-vocab", str(tmp_path / "v.txt"),
                           "-debug", "0"]) == 0
    assert (tmp_path / "v.txt").read_text().startswith("</s> ")


def test_cli_tune_subcommand_runs(tmp_path, monkeypatch, capsys):
    """`cli tune` (rejected by name before it was ported) measures the
    variants on the CPU and prints its recommendation as JSON."""
    (tmp_path / "c.txt").write_text("a b c d e f a b c d\n" * 60)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    monkeypatch.setattr(sys, "argv", [
        "cli", "tune", "-train", str(tmp_path / "c.txt"), "-min-count", "1",
        "-size", "8", "-batch-size", "32", "-steps-per-chunk", "2",
        "-debug", "0", "-tune-seconds", "0.01", "-tune-max-variants", "2",
        "-json", "1"])
    assert cli.main() == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["name"] for r in result["rows"]] == ["as-given", "fused-pool"]
    assert all(r["words_per_sec"] > 0 for r in result["rows"])


def test_port_imports_neither_jax_nor_jax_package():
    """In a fresh interpreter, importing every port module leaves JAX and
    the JAX package out of sys.modules, and no port source names them."""
    code = (
        "import pkgutil, importlib, sys, word2bits_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'word2bits_tpu' or "
        "n.startswith('word2bits_tpu.'))\n"
        "print(','.join(mods), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split(" ", 1)
    mods = out[0].split(",")
    assert len(mods) >= 20 and out[1].strip() == "[]", out
    for new in ("kernels.group_rmw", "eval.analogy", "io.packed",
                "kernels.score_pallas", "models.cbow_slab", "models.cbow",
                "kernels.hot_pallas", "kernels.scatter_pallas",
                "ops.scatter", "kernels.quantize_pallas",
                "kernels.sweep_scatter", "models.skipgram",
                "data.device_pipeline", "native", "tune", "data.structured",
                "data.wikifil", "tools.accuracy_parity", "parallel",
                "parallel.mesh", "parallel.layout", "parallel.multihost",
                "parallel.sharded", "parallel.sharded_slab",
                "parallel.sharded_skipgram", "parallel.chunk",
                "parallel.trainer", "tools.flagship_run",
                "tools.flagship_complete", "tools.flagship_transcript"):
        assert f"word2bits_tpu_torch.{new}" in mods
    pattern = re.compile(r"import jax|from jax|word2bits_tpu(?!_torch)")
    sources = [p for p in (REPO / "word2bits_tpu_torch").rglob("*")
               if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    assert any(p.suffix == ".cpp" for p in sources)
    assert len(sources) > 20
    for src in sources:
        assert not pattern.search(src.read_text()), src
    # chip_smoke.py names the TPU kernels it replaces, but imports neither
    imports = re.compile(r"^\s*(import|from)\s+(jax|word2bits_tpu)\b",
                         re.MULTILINE)
    assert not imports.search((REPO / "chip_smoke.py").read_text())
