"""Run one cell of the benchmark once on one H100:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's corpus from the seed and its vocabulary from the
configuration (its model module's `vocab_words`, benchmark/hooks.py),
builds or loads the program's kernels and warms up the cell's shapes
with a `train.train` call like the window's.  The window is then one
call of `word2bits_tpu_torch.train.train(cfg, vocab=..., encoded=...,
device="cuda")` of round(seconds / epoch_s) whole epochs, with the
cell's nominal epoch time from its file.  The work is counted by the
benchmark from its own inputs.  With `--trace 1` the same untraced window
is followed by one traced epoch under torch.profiler: the per-layer
metrics are read from that trace (and, for a rate kept per layer, from the
untraced window), and the check follows the traced epoch.
check.py then decides `correct`.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the result's
last key.  No card, or fewer than the cell asks for: exit 2, no result.
JAX, flax or the JAX package loaded by the time the run is over: exit 3,
no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "word2bits_tpu")


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    one host thread for PyTorch's CPU work (eight spinning OpenMP threads
    on a shared host made set-up take 9.5-15.2 s against 3.2-4.3 s)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    cache = os.path.join(ROOT, ".benchmark_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Ctx:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.trace = None
        self.words = None
        self.steps = 0
        self.__dict__.update(kw)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             e2e_metrics, layer_metrics, t_start: float, fault=None,
             units=None) -> dict:
    """One run of `cell`; the result's dict (see the module's doc)."""
    import torch

    from benchmark import accounting, check, hooks, work
    from benchmark.cells import reader
    from benchmark.corpus import make_corpus
    from benchmark.tap import Tap
    from word2bits_tpu_torch import train as train_mod
    from word2bits_tpu_torch.data.vocab import Vocab

    wl = cell.workload
    cuda = torch.device(device).type == "cuda"
    corpus = make_corpus(cell.config["corpus"], seed, device)
    words = hooks.of(cell.model, "vocab_words")(cell.config["corpus"],
                                                corpus.size)
    vocab = Vocab(words=words, counts=corpus.counts)
    base = cell.cfg(seed)

    def call(cfg, tap=None):
        with tap or contextlib.nullcontext():
            return train_mod.train(cfg, vocab=vocab, encoded=corpus.encoded,
                                   device=device)

    # warm-up: one epoch of the window's shapes (its time is only recorded)
    t0 = time.perf_counter()
    r = call(dataclasses.replace(base, iter=1))
    _sync(device)
    t_warm = time.perf_counter() - t0
    del r
    # a fixed amount of work for `seconds`: the cell's nominal epoch time,
    # measured on the card, sizes it (the warm-up's own time moves with
    # the host from run to run)
    epochs = max(1, round(seconds / wl["epoch_s"]))
    cfg = dataclasses.replace(base, iter=epochs)

    tap = Tap(fault=fault, batch=base.batch_size)
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    r = call(cfg, None if trace else tap)
    _sync(device)
    window_s = time.perf_counter() - t0
    tr = None
    if trace:
        # the per-layer readings: after the untraced window, whose rate a
        # per-layer metric may read, one traced epoch; the check follows it
        from benchmark.trace import traced
        del r
        cfg = dataclasses.replace(base, iter=1)
        r, tr = traced(lambda: call(cfg, tap), device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = sum(c.n_steps for c in tap.calls)
    # what the model module derives from the words, once a run, after the
    # window: the work counts and the check read it
    state = hooks.of(cell.model, "bind")(cfg, words, device)
    ctx = Ctx(setup_s=setup_s, window_s=window_s, peak_bytes=peak,
              trace=tr, steps=steps,
              shape=work.StepShape.of(cfg, corpus.counts, cell.model, state),
              words=accounting.words_consumed(corpus.counts, epochs))

    # the check
    limits = wl["limits"]
    n_last = int((tap.tokens >= 0).sum())
    got = {
        "finite_errors": check.finite_errors(r.tables, r.chunk_losses),
        "epoch_errors": check.epoch_errors(cfg, tap.tokens, tap.sents,
                                           corpus),
        "schedule_errors": check.schedule_errors(cfg, tap.calls, corpus,
                                                 n_last, cfg.iter),
        "sampler_tv": check.sampler_tv(
            tap.engine.alias, corpus.counts, seed,
            probs=hooks.of(cell.model, "negative_probs")),
    }
    steps_read = check.step_readings(cell.model, cfg, tap.chunk_fn,
                                     tap.engine.alias, r.tables, corpus,
                                     seed, check.middle_scalars(tap.calls),
                                     state=state)
    for k in ("loss_gap", "rows_gap", "delta_gap"):
        got[k] = steps_read[k]
    # a cell compares the numbers its limits name (PERF.md says why each)
    checks, correct, failed = check.judge(limits, got)

    names = layer_metrics if trace else e2e_metrics
    metrics = {}
    for name in names:
        v = reader(name)(ctx)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": units[name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.wall_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["window"] = {"epochs": epochs, "steps": steps, "warmup_s": t_warm,
                     "chunk_s": tap.chunk_times(),
                     "read": {k: v for k, v in got.items()
                              if k not in limits},
                     "compared_steps": steps_read["steps"],
                     "step_loss_gaps": steps_read["step_loss_gaps"],
                     "step_rows_gaps": steps_read["step_rows_gaps"],
                     "step_delta_gaps": steps_read["step_delta_gaps"],
                     "leaf_norms": steps_read["leaf_norms"]}
    out["checks"] = checks
    return out


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)

    from benchmark import cells
    bench = cells.benchmark_json()
    cell = cells.load_cell(args.workload, bench)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    print(f"card: {_card()}", file=sys.stderr)
    torch.cuda.set_device(0)
    e2e = cells.cell_metrics(bench, cell.name, "end_to_end")
    layer = cells.cell_metrics(bench, cell.name, "per_layer")
    units = {m: cells.unit(bench, m) for m in e2e + layer}
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   e2e, layer, T_START, units=units)
    # after the whole run, the check's model module and the readers too
    found = forbidden_modules()
    if found:
        print("run.py: loaded " + ", ".join(found), file=sys.stderr)
        return 3
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
