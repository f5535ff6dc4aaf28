"""The port's flagship tools (word2bits_tpu_torch/tools/flagship_*.py) on
the CPU at a small size.

`make_corpus` writes the JAX tool's files byte for byte (the JAX
tools/flagship_run.py loaded by path); the run goes end to end (5
segments an epoch, 2 + 1 epochs, export, evaluation over every row, the
cross-check recorded as skipped) with every file under the test's
directory, and once more on the RMW scatter's route with the epochs built
on the host; flagship_complete replays the export from the run's final
checkpoint byte for byte.
"""

import importlib.util
import json
import math
import os
from pathlib import Path

import pytest
import torch

from word2bits_tpu_torch.kernels import group_rmw, scatter_pallas
from word2bits_tpu_torch.tools import flagship_complete as FC
from word2bits_tpu_torch.tools import flagship_run as FR
from word2bits_tpu_torch.tools import flagship_transcript as FT

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--tokens", "300000", "--vocab", "5000",
         "--size", "16", "--batch", "256", "--segment", "65536"]
JAX_KEYS = ("config", "train", "resume", "artifacts", "eval", "crosscheck")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_flagship_run", REPO / "tools" / "flagship_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _docs_state():
    return {p.name: p.stat().st_mtime_ns for p in (REPO / "docs").iterdir()}


@pytest.mark.parametrize("tokens,vocab", [(300_000, 5_000),
                                          (20_000, 20_000)])  # n_fill = 0
def test_make_corpus_byte_equal_to_jax(tmp_path, tokens, vocab):
    jax_tool = _jax_tool()
    for name, make in (("jax", jax_tool.make_corpus),
                       ("port", FR.make_corpus)):
        d = tmp_path / name
        d.mkdir()
        make(str(d / "corpus.txt"), str(d / "questions.txt"), tokens, vocab)
    for f in ("corpus.txt", "corpus.txt.core", "questions.txt"):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f
    words = set((tmp_path / "port" / "corpus.txt").read_text().split())
    assert len(words) >= vocab - 600 and f"t{vocab - 601}" in words


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """One small run of the tool: (run dir, transcript dict, docs before,
    docs after)."""
    d = tmp_path_factory.mktemp("flagship")
    docs = _docs_state()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # small ops: more threads only contend
    try:
        transcript = FR.run(SMALL + ["--run-dir", str(d / "run"),
                                     "--transcript", str(d / "t.md")])
    finally:
        torch.set_num_threads(threads)
    return d, transcript, docs, _docs_state()


def test_flagship_run_end_to_end_on_cpu(flagship):
    d, t, docs_before, docs_after = flagship
    assert all(k in t for k in JAX_KEYS)
    assert t["crosscheck"] == {"skipped": FR.NO_CROSSCHECK,
                               "threshold": 50_000}
    assert t["config"]["segments_per_epoch"] == 5
    assert len(t["train"]["epoch_losses"]) == 2
    assert t["resume"]["start_epoch"] == 2
    assert len(t["resume"]["epoch_losses"]) == 1
    assert all(math.isfinite(x) for x in
               t["train"]["epoch_losses"] + t["resume"]["epoch_losses"])
    # the resumed leg starts from the trained table, not the init's
    assert (t["resume"]["first_chunk_loss_per_step"]
            > t["train"]["first_chunk_loss_per_step"])
    V, D = t["train"]["vocab_size"], 16
    assert V == t["eval"]["rows"]
    vocab = (d / "run" / "vocab.txt").read_text().split("\n")[:V]
    words = [line.split(" ")[0] for line in vocab]
    out = d / "run" / "vectors.bin"
    assert out.stat().st_size == len(f"{V} {D}\n") + sum(
        len(w.encode()) + 2 + 4 * D for w in words)
    assert (d / "run" / "vectors.bin.pack").exists()
    assert t["eval"]["coverage"] == 100.0
    assert t["eval"]["values_pm_one_third"]
    for key in ("build_s", "parse_vocab_s"):
        assert t["corpus"][key] >= 0
    assert "init" in t["train"]["seconds"]
    assert {"load", "export", "checkpoint"} <= set(t["resume"]["seconds"])
    md = (d / "t.md").read_text()
    assert md.startswith("# Smoke run") and "cpu (no card)" in md
    block = md.split("```json\n", 1)[1].split("\n```", 1)[0]
    assert json.loads(block) == json.loads(json.dumps(t))
    assert docs_after == docs_before      # nothing written under docs/


def test_flagship_complete_replays_the_export(flagship, tmp_path):
    d, t, _, _ = flagship
    run = d / "run"
    first = (run / "vectors.bin").read_bytes()
    first_pack = (run / "vectors.bin.pack").read_bytes()
    (run / "vectors.bin").unlink()
    out = FC.run(SMALL[:8] + ["--run-dir", str(run), "--transcript",
                              str(tmp_path / "c.md"), "--train-json",
                              json.dumps(t["train"])])
    assert (run / "vectors.bin").read_bytes() == first
    assert (run / "vectors.bin.pack").read_bytes() == first_pack
    assert out["train"] == json.loads(json.dumps(t["train"]))
    assert out["eval"]["total_accuracy"] == t["eval"]["total_accuracy"]
    assert out["eval"]["coverage"] == 100.0


def test_flagship_run_rmw_host_epoch_on_cpu(tmp_path, capsys, monkeypatch):
    """--rmw --host-epoch: the RMW scatter's route (one-step chunks, two
    scatters a step) on epochs built on the host, 1 + 1 epochs."""
    calls = {"rmw": 0, "grmw": 0}

    def spy(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(scatter_pallas, "scatter_add_rmw_plain",
                        spy("rmw", scatter_pallas.scatter_add_rmw_plain))
    monkeypatch.setattr(group_rmw, "scatter_add_grmw_plain",
                        spy("grmw", group_rmw.scatter_add_grmw_plain))
    args = list(SMALL)
    args[args.index("--batch") + 1] = "1024"
    t = FR.run(args + ["--rmw", "--host-epoch", "--epochs", "1",
                       "--skip-crosscheck", "--run-dir", str(tmp_path),
                       "--transcript", str(tmp_path / "t.md")])
    out = capsys.readouterr().out
    assert "Epochs built on the host" in out
    assert "Epochs built on the device" not in out
    assert t["config"]["speed_flags"] == {"rmw_scatter": True,
                                          "steps_per_chunk": 1}
    assert t["config"]["device_epoch"] == "host"
    assert t["crosscheck"]["skipped"] == "--skip-crosscheck"
    steps = t["train"]["steps"] + t["resume"]["steps"]
    assert calls == {"rmw": 2 * steps, "grmw": 0}
    assert t["resume"]["start_epoch"] == 1
    assert all(math.isfinite(x) for x in
               t["train"]["epoch_losses"] + t["resume"]["epoch_losses"])
    assert t["eval"]["coverage"] == 100.0 and t["eval"]["values_pm_one_third"]


def test_transcript_refuses_the_jax_transcripts(tmp_path):
    for path in FT.JAX_TRANSCRIPTS:
        with pytest.raises(ValueError):
            FT.write_transcript({}, path, 60_000_000, 3_700_000, 800, "x")
    big = FT.write_transcript({"device": {"card": "some card, 700.00 W"}},
                              str(tmp_path / "t.md"), 60_000_000,
                              3_700_000, 800, "x")
    assert Path(big).read_text().startswith("# Flagship end-to-end run")
    assert "some card, 700.00 W" in Path(big).read_text()
    assert not os.path.exists(REPO / "docs" / "t.md")
    # the full-scale rule needs both sizes
    small = FT.write_transcript({}, str(tmp_path / "s.md"), 49_999_999,
                                3_700_000, 800, "x")
    assert Path(small).read_text().startswith("# Smoke run")
