"""run.py and the check on the CPU at a tiny size: a sound run is correct;
the planted faults and the control are not; without a card run.py exits
nonzero and prints no result; nothing run.py loads is JAX or the JAX
package, and the reference loads nothing of the program either."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import cells, check, run
from benchmark.cells import ROOT
from benchmark.tests import tiny

KINDS = ("capacity", "shipped")
SEED = 2 ** 31 + 7


def _run(kind, fault=None, trace=False):
    return run.run_cell(tiny.cell(kind), SEED, 0.2, trace, "cpu",
                        tiny.E2E, tiny.LAYER, time.perf_counter(),
                        fault=fault, units=tiny.UNITS)


@pytest.mark.parametrize("kind", KINDS + ("split",))
def test_sound_run_is_correct(kind):
    out = _run(kind)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]
    assert out["metrics"]["train_words_per_s.t"]["value"] > 0
    # every compared step of the chunk: the first, the middle, the last
    S = tiny.cell(kind).cfg(SEED).steps_per_chunk
    assert out["window"]["compared_steps"] == [0, S // 2, S - 1]
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault", ["frozen", "half", "plan0", "nodecay"])
def test_planted_fault_is_not_correct(kind, fault):
    out = _run(kind, fault=fault)
    assert not out["correct"]
    c = out["checks"]
    assert max(c[k][0] / c[k][1]
               for k in ("rows_gap", "delta_gap", "loss_gap")) > 3


@pytest.mark.parametrize("kind", KINDS)
def test_control_is_not_correct(kind):
    """The reference one precision lower in the program's place."""
    from benchmark.corpus import make_corpus, word_names
    from benchmark.tap import Tap
    from word2bits_tpu_torch import train
    from word2bits_tpu_torch.data.vocab import Vocab
    cell = tiny.cell(kind)
    corpus = make_corpus(cell.config["corpus"], SEED, "cpu")
    vocab = Vocab(words=word_names(corpus.size), counts=corpus.counts)
    cfg = dataclasses.replace(cell.cfg(SEED), iter=1)
    tap = Tap(batch=cfg.batch_size)
    with tap:
        r = train.train(cfg, vocab=vocab, encoded=corpus.encoded,
                        device="cpu")
    got = check.step_readings(cell.model, cfg, tap.chunk_fn,
                              tap.engine.alias, r.tables, corpus, SEED,
                              check.middle_scalars(tap.calls), mode="control")
    lim = cell.workload["limits"]
    _, correct, _ = check.judge(
        {k: v for k, v in lim.items() if k in got}, got)
    assert not correct, got


def test_traced_run_on_cpu_reads_no_device_metric():
    """Only the host clock's rate of the untraced window that precedes the
    traced epoch; the check follows that epoch."""
    out = _run("shipped", trace=True)
    assert out["correct"] and list(out["metrics"]) == ["host_words_per_s.t"]
    assert out["metrics"]["host_words_per_s.t"]["value"] > 0
    assert out["device"]["busy_s"] == 0.0
    assert out["window"]["epochs"] >= 1 and out["attempted"] > 0


def test_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "text8.shipped-span", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


DRY = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.tests import tiny
run.run_cell(tiny.cell("capacity"), 5, 0.1, False, "cpu", tiny.E2E,
             tiny.LAYER, time.perf_counter(), units=tiny.UNITS)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REF = """
import json, sys
sys.path.insert(0, {root!r})
import {module}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
# every model module that a cell of BENCHMARK.json is checked by
MODEL_MODULES = sorted({cells.load_cell(w["name"]).model.__name__
                        for w in cells.benchmark_json()["workloads"]})


def _top_level(code, **names):
    p = subprocess.run([sys.executable, "-c", code.format(root=ROOT, **names)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = _top_level(DRY)
    assert "word2bits_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "word2bits_tpu"}


@pytest.mark.parametrize("module", MODEL_MODULES)
def test_reference_loads_nothing_of_either_package(module):
    names = _top_level(REF, module=module)
    assert not names & {"jax", "jaxlib", "flax", "word2bits_tpu",
                        "word2bits_tpu_torch"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wiki.capacity-grmw", "text8.shipped-span"])
def test_cell_on_the_card(card, name):
    """One short run of each cell on the card: correct."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
