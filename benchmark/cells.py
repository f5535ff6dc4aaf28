"""Cells, configurations and metrics, found by name from their files.

- BENCHMARK.json (the repository's root) lists the cells and metrics;
- a cell is benchmark/workloads/<name>.json: its configuration, the
  engine flags, its nominal epoch time, the limits of its check and why;
- a configuration is benchmark/configs/<name>.json: the model's flags, the
  corpus made from the seed, where it comes from and how it was cut;
- a metric `<base>.<suffix>` is read by benchmark/metrics/<base>.py, and
  `<kernel>_roofline.<suffix>` by metrics/roofline.py with the kernel's
  counts in benchmark/kernels/<kernel>.py.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    chips: int = 1

    @property
    def argv(self) -> List[str]:
        return list(self.config["flags"]) + list(self.workload["flags"])

    def cfg(self, seed: int, **fields):
        """The program's Word2BitsConfig of this cell (config_from_argv),
        with `-seed`, `-debug 0` and `fields` replaced."""
        import dataclasses

        from word2bits_tpu_torch.config import config_from_argv
        cfg = config_from_argv(self.argv + ["-seed", str(int(seed)),
                                            "-debug", "0"])
        return dataclasses.replace(cfg, **fields) if fields else cfg


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    wl = _json(os.path.join(HERE, "workloads", f"{name}.json"))
    cf = _json(os.path.join(HERE, "configs", f"{wl['config']}.json"))
    chips = 1
    for w in (bench or {}).get("workloads", []):
        if w["name"] == name:
            chips = int(w["chips"])
    return Cell(name=name, workload=wl, config=cf, chips=chips)


def cell_metrics(bench: dict, name: str, group: str) -> List[str]:
    """The names of the `group` ("end_to_end" or "per_layer") metrics that
    cell `name` reports: those that list it, or list no cells and move an
    end-to-end metric the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if group == "end_to_end":
        return e2e
    out = []
    for m in bench["per_layer"]:
        if name in m.get("workloads", []) or (
                "workloads" not in m and m["moves"] in e2e):
            out.append(m["name"])
    return out


def reader(metric: str):
    """read(ctx) -> value or None, for a metric's name."""
    base = metric.split(".")[0]
    if base.endswith("_roofline"):
        kernel = importlib.import_module(
            f"benchmark.kernels.{base[:-len('_roofline')]}")
        roof = importlib.import_module("benchmark.metrics.roofline")
        return lambda ctx: roof.read(ctx, kernel)
    return importlib.import_module(f"benchmark.metrics.{base}").read


def unit(bench: dict, metric: str) -> str:
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == metric:
            return m["unit"]
    raise KeyError(metric)
