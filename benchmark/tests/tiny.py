"""Tiny cells for the CPU tests: the shipped cells' flags at a size a test
run holds ("capacity", "shipped"), and the Quick start's split float32
tables with the `add` scatter ("split"), with limits set from CPU readings
at this size (far below the control's and the faults')."""

from benchmark.cells import Cell

LIMITS = {"finite_errors": 0, "epoch_errors": 0, "schedule_errors": 0,
          "sampler_tv": 0.02, "loss_gap": 1e-4, "rows_gap": 0.25,
          "delta_gap": 1e-2}
E2E = ["setup_s", "train_words_per_s.t", "peak_device_GB"]
LAYER = ["device_idle_pct.t", "step_mfu.t", "launches_per_step.t",
         "host_words_per_s.t",
         "device_us_per_step.t", "plain_ops_us_per_step.t",
         "context_roofline.t", "span_scatter_roofline.t",
         "group_rmw_roofline.t"]
UNITS = {m: "u" for m in E2E + LAYER}


def cell(kind: str) -> Cell:
    one_line = kind == "shipped"
    config = {"flags": ["-size", "16", "-window", "3", "-negative", "5",
                        "-min-count", "5", "-sample", "1e-3",
                        "-bitlevel", "1"],
              "corpus": {"n_types": 400, "head": 3000, "s": 1.05,
                         "min_count": 5, "sentence": 0 if one_line else 20},
              "reference": "benchmark/reference.py"}
    if kind == "capacity":
        flags = ["-dtype", "bfloat16", "-fused-tables", "1",
                 "-neg-sharing", "16", "-batch-size", "64",
                 "-steps-per-chunk", "4", "-loop-mode", "fori",
                 "-scatter-impl", "grmw", "-banded-tile", "32",
                 "-context-pallas", "1"]
        wl = {"flags": flags, "epoch_s": 0.1}
    elif kind == "split":
        flags = ["-batch-size", "64", "-steps-per-chunk", "4",
                 "-scatter-impl", "add"]
        wl = {"flags": flags, "epoch_s": 0.1}
    else:
        flags = ["-alpha", "0.1", "-dtype", "bfloat16", "-fused-tables",
                 "1", "-neg-sharing", "16", "-neg-pool", "2",
                 "-batch-size", "64", "-steps-per-chunk", "8",
                 "-banded-tile", "32", "-scatter-impl", "span",
                 "-context-pallas", "1"]
        wl = {"flags": flags, "epoch_s": 0.1}
    wl["limits"] = dict(LIMITS)
    return Cell(name=f"tiny.{kind}", workload=wl, config=config)
