"""The port's `cli tune` (tune.py) on the CPU.

Every variant the port offers validates in the port's config and is the
JAX package's variant (its overlay and note), but for the port's one
change: the hot-rows overlay also asks for kernel 6 (`-hot-pallas 1`).
The skip-gram branch, -tune-max-variants and -json 1 behave as the JAX
package's, and an end-to-end `cli tune` measures every variant.
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

from word2bits_tpu import tune as jtune
from word2bits_tpu.config import Word2BitsConfig as JConfig
from word2bits_tpu_torch import cli
from word2bits_tpu_torch import tune as ttune
from word2bits_tpu_torch.config import Word2BitsConfig as TConfig


def _corpus(tmp_path) -> str:
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(80)]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(
        " ".join(words[rng.integers(80)] for _ in range(12))
        for _ in range(300)) + "\n")
    return str(corpus)


BASE = dict(size=16, window=3, negative=5, min_count=1, batch_size=64,
            steps_per_chunk=2, iter=1, seed=1, debug=0)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(bitlevel=4),
    dict(reg=0.01),
    dict(fused_tables=True, neg_sharing=8),
    dict(dtype="bfloat16", steps_per_chunk=128),
    dict(batch_size=256, fused_tables=True, neg_sharing=64, neg_pool=2,
         banded_tile=256, scatter_impl="add", context_pallas=True,
         dtype="bfloat16", steps_per_chunk=256),
    dict(model="skipgram"),
    dict(model="skipgram", hot_rows=8, neg_dense_hot=True,
         dtype="bfloat16"),
])
def test_variants_validate_and_equal_jax(kw):
    kw = dict(BASE, **kw)
    tcfg, jcfg = TConfig(**kw), JConfig(**kw)
    for V in (81, 20_000):
        tv, jv = ttune.variants(tcfg, V), jtune.variants(jcfg, V)
        assert [n for n, _, _ in tv] == [n for n, _, _ in jv]
        for (name, overlay, note), (_, jo, jn) in zip(tv, jv):
            want = dict(jo, hot_pallas=True) if name == "hot-rows" else jo
            assert overlay == want and note == jn
            dataclasses.replace(tcfg, **overlay)   # the port's config
            assert ttune._flags(overlay) == jtune._flags(jo) + (
                " -hot-pallas 1" if name == "hot-rows" else "")


def test_variants_skipgram_branch():
    sg = TConfig(**BASE, model="skipgram")
    assert [n for n, _, _ in ttune.variants(sg, 81)] == ["as-given",
                                                         "dense-hot", "bf16"]
    dense = TConfig(**BASE, model="skipgram", hot_rows=8, neg_dense_hot=True,
                    dtype="bfloat16")
    assert [n for n, _, _ in ttune.variants(dense, 81)] == ["as-given"]


def test_variants_mesh_branch_measures_as_given(tmp_path, monkeypatch,
                                               capsys):
    """With -mesh-shape both packages offer the flags as given, and `cli
    tune` measures them on the mesh (here one shard: a one-rank gloo
    group of its own)."""
    assert ttune.variants(SimpleNamespace(mesh_shape={"data": 2}), 81) == [
        ("as-given", {}, "your flags unchanged")]
    kw = dict(train_file="x", mesh_shape={"data": 2, "vocab": 4}, **BASE)
    assert ttune.variants(TConfig(**kw), 81) == jtune.variants(
        JConfig(**kw), 81)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    assert cli.tune_main(["-train", _corpus(tmp_path), "-size", "16",
                          "-min-count", "1", "-batch-size", "64",
                          "-steps-per-chunk", "2", "-debug", "0",
                          "-mesh-shape", "data=1,vocab=1", "-tune-seconds",
                          "0.01", "-json", "1"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["name"] for r in result["rows"]] == ["as-given"]
    assert result["rows"][0]["words_per_sec"] > 0


def test_run_tune_max_variants_and_json(tmp_path, capsys):
    cfg = TConfig(train_file=_corpus(tmp_path), **BASE)
    assert ttune.run_tune(cfg, seconds=0.01, as_json=True, max_variants=3,
                          device="cpu") == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert sum("M words/sec" in line for line in out) == 3
    result = json.loads(out[-1])
    assert [r["name"] for r in result["rows"]] == ["as-given", "fused-pool",
                                                   "hot-rows"]
    assert result["recommended"] in ("as-given", "fused-pool", "hot-rows")
    assert result["speedup_vs_given"] > 0
    assert set(result) == {"recommended", "flags", "words_per_sec",
                           "speedup_vs_given", "rows"}


def test_run_tune_skipgram_text_output(tmp_path, capsys):
    cfg = TConfig(train_file=_corpus(tmp_path), **BASE, model="skipgram")
    assert ttune.run_tune(cfg, seconds=0.01, device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("M words/sec") == 3 and "tune: recommended:" in out


def test_measure_counts_words_and_frees_nothing_shared(tmp_path):
    """measure() on a prepared epoch: a positive rate, for a fused
    hot-rows variant too (its cold map built as the JAX package's)."""
    from word2bits_tpu_torch.data.pipeline import build_epoch_arrays
    from word2bits_tpu_torch.train import prepare, segment_capacity
    cfg = TConfig(train_file=_corpus(tmp_path), **BASE)
    vocab, enc = prepare(cfg)
    seg, cap = segment_capacity(cfg, len(enc))
    ep = build_epoch_arrays(enc, vocab.counts, cfg.sample, vocab.train_words,
                            cfg.window, np.random.default_rng(1),
                            capacity=cap)
    for overlay in ({}, dict(fused_tables=True, neg_sharing=64,
                             hot_rows=40, hot_pallas=True)):
        wps = ttune.measure(dataclasses.replace(cfg, **overlay), vocab, ep,
                            cap, seg, len(enc), seconds=0.01, group=2,
                            device="cpu")
        assert wps > 0


def test_cli_tune_end_to_end(tmp_path, monkeypatch, capsys):
    """`cli tune` on the CPU measures every variant (none reports an
    error) and recommends one of them."""
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    argv = ["-train", _corpus(tmp_path), "-size", "16", "-window", "3",
            "-negative", "5", "-min-count", "1", "-batch-size", "64",
            "-steps-per-chunk", "2", "-debug", "0", "-tune-seconds", "0.01",
            "-json", "1"]
    assert cli.tune_main(argv) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = [r["name"] for r in result["rows"]]
    assert names == [n for n, _, _ in ttune.variants(
        cli.config_from_argv(argv[:-4]), 81)]
    assert all("words_per_sec" in r for r in result["rows"])
    assert result["recommended"] in names
    assert cli.tune_main(["-size", "16"]) == 0      # usage without -train
