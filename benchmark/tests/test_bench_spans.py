"""The readers of the program's spans (benchmark/spans.py and the five
metrics built on it) on a hand-made trace with known answers; nothing to
read without spans; and a tiny traced run on the CPU, where the two
readings that need no device activity read a number."""

import sys
import time

import pytest

from benchmark import run
from benchmark.cells import reader
from benchmark.tests import tiny
from benchmark.trace import Trace

NEW = ["loop_idle_pct", "issue_idle_pct", "host_us_per_step",
       "epoch_build_ms", "call_setup_s"]
BASE_NS = 1_792_288_109_814_817_713       # Unix time in ns, as recorded


class Ctx:
    def __init__(self, trace, steps):
        self.trace, self.steps = trace, steps


def _spans():
    """A one-epoch call, in us after BASE_NS: set-up, the build (its wait
    nested), two chunk calls, the final build of no segment, the fetch;
    one host segment's upload nested in the build (not set-up)."""
    us = [("init", 0, 1000, -1), ("alias", 1000, 1500, -1),
          ("upload", 1500, 2000, -1), ("epoch", 2000, 10000, -1),
          ("epoch_build", 2000, 3000, 3), ("upload", 2200, 2300, 4),
          ("epoch_build.wait", 2800, 3000, 4), ("chunk", 3000, 6000, 3),
          ("step", 3000, 4500, 7), ("chunk", 6500, 9000, 3),
          ("epoch_build", 9000, 9500, 3), ("fetch", 9500, 10000, 3)]
    return [(n, BASE_NS + a * 1000, BASE_NS + b * 1000, p)
            for n, a, b, p in us]


def _trace():
    t0 = BASE_NS * 1e-9
    busy = [(200, 800), (2100, 2700), (3100, 3500), (3600, 4000),
            (5000, 7000), (9600, 9700)]
    dev = [("k", t0 + a * 1e-6, t0 + b * 1e-6) for a, b in busy]
    return Trace(device=dev, host=[], wall_s=0.0105)


@pytest.fixture
def recorded(monkeypatch):
    from word2bits_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", _spans)


def test_readings_of_a_hand_made_call(recorded):
    ctx = Ctx(_trace(), 10)
    # the epoch: 8000 us, 3500 of them busy
    assert reader("loop_idle_pct.x")(ctx) == pytest.approx(56.25, rel=1e-4)
    # idle gaps in the epoch with their middle in a chunk: 3500-3600,
    # 4000-5000, 7000-9600 (past the chunk's end, its middle inside);
    # not 2700-3100 (overlapping the first chunk, its middle outside)
    assert reader("issue_idle_pct.x")(ctx) == pytest.approx(
        100 * 3700 / 8000, rel=1e-4)
    assert reader("host_us_per_step.x")(ctx) == pytest.approx(550, rel=1e-4)
    # busy inside the two builds: 600 us, one epoch (seconds of Unix time
    # in float64 resolve 0.24 us)
    assert reader("epoch_build_ms.x")(ctx) == pytest.approx(0.6, abs=1e-3)
    # init + alias + the top-level upload; the segment's upload is not
    assert reader("call_setup_s.x")(ctx) == pytest.approx(0.002, rel=1e-4)


def test_nothing_to_read_without_spans(monkeypatch):
    from word2bits_tpu_torch import utils
    from word2bits_tpu_torch.utils import trace
    ctx = Ctx(_trace(), 10)
    monkeypatch.setattr(trace, "spans", list)
    for m in NEW:
        assert reader(m + ".x")(ctx) is None, m
    # a program without the span recorder (an earlier commit)
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "word2bits_tpu_torch.utils.trace", None)
    for m in NEW:
        assert reader(m + ".x")(ctx) is None, m


def test_device_readings_need_device_activity(recorded):
    for tr in (None, Trace(wall_s=1.0)):
        ctx = Ctx(tr, 10)
        for m in ("loop_idle_pct", "issue_idle_pct", "epoch_build_ms"):
            assert reader(m + ".x")(ctx) is None, m
        assert reader("host_us_per_step.x")(ctx) == pytest.approx(550,
                                                                  rel=1e-4)
        assert reader("call_setup_s.x")(ctx) == pytest.approx(0.002,
                                                              rel=1e-4)


def test_traced_run_on_cpu_reads_the_host_spans():
    names = [m + ".t" for m in NEW]
    units = dict(tiny.UNITS, **{m: "u" for m in names})
    out = run.run_cell(tiny.cell("shipped"), 2 ** 31 + 7, 0.2, True, "cpu",
                       tiny.E2E, tiny.LAYER + names, time.perf_counter(),
                       units=units)
    assert out["correct"]
    got = out["metrics"]
    assert set(got) == {"host_words_per_s.t", "host_us_per_step.t",
                        "call_setup_s.t"}
    assert got["host_us_per_step.t"]["value"] > 0
    assert 0 < got["call_setup_s.t"]["value"] < out["window"]["warmup_s"]
