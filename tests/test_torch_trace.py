"""The program's spans (word2bits_tpu_torch/utils/trace.py) on the CPU.

Off (no profiler recording): `span` hands out one shared no-op object and
a train() call records nothing, while TrainResult.seconds is still timed.
On (a CPU-only torch.profiler session around train()): the spans carry
the names of the loop's sites, nest step in chunk in epoch and the epoch
build's wait in the build, count one `step` a training step, and lie on
the profiler's clock inside its session.
"""

import collections
import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain
from word2bits_tpu_torch.utils import trace

BASE = ["-min-count", "1", "-debug", "0", "-size", "8", "-batch-size", "32",
        "-steps-per-chunk", "4", "-iter", "2"]
# the benchmark cells' engine: fused bf16 table, span scatter, context
# kernel's path, the epoch built on the device
FUSED = ["-fused-tables", "1", "-neg-sharing", "8", "-dtype", "bfloat16",
         "-banded-tile", "16", "-context-pallas", "1"]
FUSED_SPAN = FUSED + ["-scatter-impl", "span", "-device-epoch", "1"]
STEP_PARTS = {"step.gather", "step.positive", "step.negative", "step.rows",
              "step.scatter"}
# skip-gram's step has no separate rows phase (both routes)
SKIPGRAM_PARTS = STEP_PARTS - {"step.rows"}
ENGINES = {
    "fused-span": FUSED_SPAN,
    "fused-grmw-host-epoch": FUSED + ["-scatter-impl", "grmw",
                                      "-device-epoch", "0"],
    "slab": [],
    "skipgram": ["-model", "skipgram"],
    "skipgram-pairs": ["-model", "skipgram", "-neg-per-pair", "1"],
    "mesh": ["-neg-sharing", "8", "-mesh-shape", "data=1,vocab=1"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, argv):
    (tmp_path / "c.txt").write_text("a b c d e f a b c d\n" * 60)
    return tconfig.config_from_argv(argv + BASE + ["-train",
                                                   str(tmp_path / "c.txt")])


def _recorded(cfg):
    """train() under a CPU-only profiler: (result, spans, the session's
    start and end on the profiler's clock, its events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = ttrain.train(cfg, device="cpu")
    t_end = time.time_ns()
    k = prof.profiler.kineto_results
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in k.events()]
    return res, trace.spans(), k.trace_start_ns(), t_end, events


def test_off_records_nothing_and_still_times(tmp_path):
    assert trace.span("a") is trace.span("step.gather")
    trace.clear()
    res = ttrain.train(_cfg(tmp_path, FUSED_SPAN), device="cpu")
    assert trace.spans() == []
    for k in ("init", "alias", "upload", "epoch_build", "epoch_build_wait",
              "issue"):
        assert res.seconds[k] > 0, k


def test_phase_seconds_exclude_nested_phases():
    sec = {}
    with trace.phase("epoch_build", sec):
        time.sleep(0.02)
        with trace.phase("epoch_build.wait", sec):
            time.sleep(0.1)
    with trace.phase("chunk", sec, "issue"):
        pass
    assert sec["epoch_build_wait"] >= 0.1
    assert 0.02 <= sec["epoch_build"] < 0.1
    assert set(sec) == {"epoch_build", "epoch_build_wait", "issue"}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_spans_of_a_recorded_train_call(tmp_path, engine):
    cfg = _cfg(tmp_path, ENGINES[engine])
    res, sp, t0, t1, events = _recorded(cfg)
    names = collections.Counter(n for n, *_ in sp)
    fused = engine.startswith("fused")
    want = {"init", "alias", "upload", "epoch", "epoch_build", "chunk",
            "step", "fetch"}
    if cfg.device_epoch_on:
        want.add("epoch_build.wait")
    parts = set()
    if fused:
        parts = STEP_PARTS
        want |= {"chunk.draws", "chunk.plan"} | parts
    elif engine.startswith("skipgram"):
        parts = SKIPGRAM_PARTS
        want |= {"chunk.draws"} | parts
    assert set(names) == want
    assert names["step"] == res.steps > 0
    assert names["epoch"] == cfg.iter
    assert all(names[p] == res.steps for p in parts)

    def parent(i):
        return sp[sp[i][3]][0] if sp[i][3] >= 0 else None

    for i, (name, a, b, p) in enumerate(sp):
        assert t0 <= a <= b <= t1, name
        if p >= 0:   # inside its parent
            assert sp[p][1] <= a and b <= sp[p][2]
        if name == "step":
            assert parent(i) == "chunk" and parent(p) == "epoch"
        elif name.startswith(("step.", "chunk.")):
            assert parent(i) == name.split(".")[0]
        elif name == "epoch_build.wait":
            assert parent(i) == "epoch_build"
        elif name == "chunk":
            assert parent(i) == "epoch"
        elif name == "epoch_build":
            assert parent(i) == "epoch"
        elif name == "upload":
            # once before the epochs, or each host-built segment's
            assert parent(i) in (None, "epoch_build")
            assert (parent(i) is None) == cfg.device_epoch_on
        elif name in ("init", "alias", "epoch"):
            assert p == -1
    # on the profiler's clock: every scatter span holds the ops it issued
    if parts:
        starts = [a for n, a, _ in events if n.startswith("aten::")]
        for name, a, b, _ in sp:
            if name == "step.scatter":
                assert any(a <= s <= b for s in starts)
    assert res.seconds["epoch_build_wait"] >= 0 and res.seconds["issue"] > 0


def test_train_clears_spans_on_entry_while_recording(tmp_path):
    cfg = _cfg(tmp_path, FUSED_SPAN)
    _recorded(cfg)
    res, sp, *_ = _recorded(cfg)
    assert sum(n == "step" for n, *_ in sp) == res.steps
    trace.clear()
    assert trace.spans() == []


def test_profile_dir_of_a_one_chunk_run(tmp_path):
    """-profile-dir traces the run's only chunk call where it makes one."""
    import json
    import os
    pdir = tmp_path / "prof"
    cfg = dataclasses.replace(
        _cfg(tmp_path, FUSED_SPAN + ["-profile-dir", str(pdir)]), iter=1)
    res = ttrain.train(cfg, device="cpu")
    assert len(res.chunks) == 1
    (name,) = os.listdir(pdir)
    with open(pdir / name) as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events if e.get("cat") == "w2b"]
    assert spans.count("chunk") == 1 and spans.count("step") == res.steps


def test_profile_step_groups_idle_by_the_innermost_span():
    from word2bits_tpu_torch.tools.profile_step import idle_by_span
    busy = [(0, 10), (20, 30), (25, 40), (100, 110), (300, 310)]
    spans = [("chunk", 0, 200, -1), ("step", 15, 50, 0),
             ("step.scatter", 18, 22, 1)]
    # gaps 10-20 (middle in step), 40-100 (chunk), 110-300 (outside)
    assert idle_by_span(busy, spans) == {"step": 10, "chunk": 60,
                                         None: 190}
