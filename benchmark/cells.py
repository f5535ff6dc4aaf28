"""Cells, configurations and metrics, found by name from their files.

- BENCHMARK.json (the repository's root) lists the cells and metrics;
- a cell is benchmark/workloads/<name>.json: its configuration, the
  engine flags, its nominal epoch time, the limits of its check and why;
- a configuration is benchmark/configs/<name>.json: the model's flags, the
  corpus made from the seed, where it comes from and how it was cut, and
  in `reference` its model module (a file under benchmark/), which the
  check and the work counts take everything model-specific from;
- a metric `<base>.<suffix>` is read by benchmark/metrics/<base>.py, and
  `<kernel>_roofline.<suffix>` by metrics/roofline.py with the kernel's
  counts in benchmark/kernels/<kernel>.py.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from dataclasses import dataclass, field
from types import ModuleType
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# what a model module provides (benchmark/README.md, "A configuration of
# another model"); the pieces it may give besides, and their defaults, are
# in hooks.py
CONTRACT = ("MODELS", "hyper", "negative_shape", "step", "step_flops",
            "step_bytes")
MODULE_PATH = re.compile(r"benchmark(/[A-Za-z_][A-Za-z0-9_]*)+\.py")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def model_module(config: dict, model: str) -> ModuleType:
    """The model module that a configuration's `reference` key names: a
    .py file under benchmark/, relative to the repository's root, that has
    every piece of CONTRACT and follows `model` (the program's -model of
    the cell).  Raises ValueError, naming the key, where it does not."""
    path = config.get("reference")
    where = f"configuration {config.get('name', '?')}: `reference` {path!r}"
    if not isinstance(path, str) or not MODULE_PATH.fullmatch(path):
        raise ValueError(f"{where} names no .py file under benchmark/")
    if not os.path.isfile(os.path.join(ROOT, path)):
        raise ValueError(f"{where}: no such file")
    module = importlib.import_module(path[:-3].replace("/", "."))
    missing = [k for k in CONTRACT if not hasattr(module, k)]
    if missing:
        raise ValueError(f"{where} lacks {', '.join(missing)} of the model "
                         "module's contract")
    if model not in module.MODELS:
        raise ValueError(f"{where} follows -model "
                         f"{' or '.join(module.MODELS)}, not {model}")
    return module


@dataclass
class Cell:
    """A cell: its workload and configuration files and, resolved from the
    configuration's `reference` key, its model module."""
    name: str
    workload: dict
    config: dict
    chips: int = 1
    model: ModuleType = field(init=False)

    def __post_init__(self):
        self.model = model_module(self.config, self.cfg(0).model)

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
    """Cell `name` from its files (chips from BENCHMARK.json's entry);
    ValueError where its configuration's `reference` key names no model
    module that follows the cell's -model (model_module)."""
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
