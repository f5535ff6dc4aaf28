"""Cells, configurations and metrics are found by name from their files,
and BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.benchmark_json()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    path = os.path.join(cells.ROOT, entry["file"])
    cf = json.load(open(path))
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert cf["name"] == entry["name"] and cf["source"] == entry["source"]
    assert cf["reduced"] == entry["reduced"]
    for k in entry["reduced"]:
        assert NAME.match(k) and not k.endswith(("_dim", "_rank", "size"))
        assert k not in ("window", "negative", "bitlevel")
    assert 0 < len(entry["why"]) <= 200


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    cell = cells.load_cell(entry["name"], BENCH)
    assert cell.workload["config"] == entry["config"]
    assert cell.workload["why"] == entry["why"]
    assert 0 < len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert entry["chips"] == 1 == cell.chips
    cfg = cell.cfg(2 ** 31 + 11)
    assert cfg.size == cell.config["size"]
    assert cfg.window == cell.config["window"]
    assert cfg.negative == cell.config["negative"]
    assert cfg.bitlevel == cell.config["bitlevel"]
    lim = cell.workload["limits"]
    assert set(lim) == {"finite_errors", "epoch_errors", "schedule_errors",
                        "sampler_tv", "loss_gap", "rows_gap", "delta_gap"}
    assert all(lim[k] == 0 for k in lim if k.endswith("_errors"))
    e2e = cells.cell_metrics(BENCH, entry["name"], "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cells.cell_metrics(BENCH, entry["name"], "per_layer")


def test_every_config_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(cells.reader(metric["name"]))
    names = [w["name"] for w in BENCH["workloads"]]
    for w in metric.get("workloads", []):
        assert w in names
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        for w in metric["workloads"]:
            assert w in e2e[metric["moves"]].get("workloads", [w])
        assert 0 < len(metric["layer"]) <= 200


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_roofline_reader_finds_the_kernel_file():
    from benchmark.kernels import context, group_rmw, span_scatter
    for mod in (context, group_rmw, span_scatter):
        assert mod.PATTERNS and callable(mod.per_step)
