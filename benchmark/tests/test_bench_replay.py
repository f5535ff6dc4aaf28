"""replay_step_pct (benchmark/metrics/replay_step_pct.py): the share of
the steps replayed from a CUDA graph, read from the program's spans, and
nothing without the replay's spans."""

import pytest

from benchmark.cells import reader

BASE_NS = 1_792_288_109_814_817_713


class Ctx:
    trace = None

    def __init__(self, steps):
        self.steps = steps


def _spans(names):
    return lambda: [(n, BASE_NS + i * 1000, BASE_NS + i * 1000 + 500, -1)
                    for i, n in enumerate(names)]


@pytest.mark.parametrize("names, steps, want", [
    (["chunk", "step", "capture"] + ["step", "step.inputs",
                                     "step.replay"] * 7, 8, 87.5),
    (["chunk"] + ["step", "step.inputs", "step.replay"] * 4, 4, 100.0),
    (["chunk", "step", "capture"], 1, 0.0),
])
def test_share_of_replayed_steps(monkeypatch, names, steps, want):
    from word2bits_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", _spans(names))
    assert reader("replay_step_pct.x")(Ctx(steps)) == pytest.approx(want)


@pytest.mark.parametrize("names, steps", [
    (["chunk", "step", "step.gather", "step"], 2),   # a program without it
    ([], 2),
    (["step.replay"], 0),
])
def test_nothing_to_read(monkeypatch, names, steps):
    from word2bits_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", _spans(names))
    assert reader("replay_step_pct.x")(Ctx(steps)) is None
