"""Readings that the limits of a cell's check are set from, on the card at
the cell's own size (not run by the benchmark's runs):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--modes program,control,half,frozen,plan0,nodecay,sampler] \\
        [--out FILE]

Per seed: the cell's corpus and one epoch of `train.train` under tap.py,
as a window of one epoch.  From copies of its trained state, the check's
step readings (check.step_readings, against the cell's model module) of

- program: the program's chunk, as every run reads it;
- control: the reference one precision lower (bf16 for float32 tables,
  fp8 e4m3 storage and bf16 arithmetic for bf16 tables) in its place;
- half:    the program with half of each batch left out, at twice the rate
  (a fault tap.py plants);
- frozen:  the program's chunk returning the tables as they came in;
- plan0:   every step of a chunk given the first step's share of the
  hoisted scatter plan;
- nodecay: the learning rate held at its start;
- sampler: the program, with the sampler's draws made uniform.

Which modes apply to which engine: program, control, half, frozen,
nodecay and sampler to every engine; plan0 only to the fused engine with
the `span` or `grmw` scatter (-fused-tables 1 on CBOW), the one chunk that
calls models.cbow_fused.scatter_plan.  A mode that the cell's engine
cannot have is reported as "n/a" and not read (tap.NotPlanted).

Each mode's numbers, with the window's other checks, go through the
cell's own limits (check.judge, as run.py judges a run): one JSON line
per seed and mode with `correct` (or "n/a") and the numbers that failed.
"""

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_KEYS = ("loss_gap", "rows_gap", "delta_gap")
MODES = ("program", "control", "half", "frozen", "plan0", "nodecay",
         "sampler")


def seed_lines(cell, seed: int, modes, device):
    """One seed's readings of `cell`: a dict per mode, as main prints it."""
    import torch

    from benchmark import check, hooks
    from benchmark.corpus import make_corpus
    from benchmark.tap import NotPlanted, Tap, faulted
    from word2bits_tpu_torch import train as train_mod
    from word2bits_tpu_torch.data.vocab import Vocab

    limits = cell.workload["limits"]
    corpus = make_corpus(cell.config["corpus"], seed, device)
    words = hooks.of(cell.model, "vocab_words")(cell.config["corpus"],
                                                corpus.size)
    vocab = Vocab(words=words, counts=corpus.counts)
    cfg = dataclasses.replace(cell.cfg(seed), iter=1)
    B = cfg.batch_size
    tap = Tap(batch=B)
    with tap:
        r = train_mod.train(cfg, vocab=vocab, encoded=corpus.encoded,
                            device=device)
    alias = tap.engine.alias
    state = hooks.of(cell.model, "bind")(cfg, words, device)
    probs = hooks.of(cell.model, "negative_probs")
    scalars = check.middle_scalars(tap.calls)
    window = {
        "finite_errors": check.finite_errors(r.tables, r.chunk_losses),
        "epoch_errors": check.epoch_errors(cfg, tap.tokens, tap.sents,
                                           corpus),
        "schedule_errors": check.schedule_errors(
            cfg, tap.calls, corpus, int((tap.tokens >= 0).sum()), 1),
        "sampler_tv": check.sampler_tv(alias, corpus.counts, seed,
                                       probs=probs),
    }
    head = {"workload": cell.name, "seed": seed}
    program = None
    for mode in modes:
        t1 = time.perf_counter()
        got = dict(window)
        if mode == "control":
            got.update(check.step_readings(cell.model, cfg, tap.chunk_fn,
                                           alias, r.tables, corpus, seed,
                                           scalars, mode="control",
                                           state=state))
        elif mode == "sampler":
            def uniform(gen, atab, shape, V):
                return torch.randint(1, V, shape, generator=gen,
                                     device=device)
            got.update({k: program[k] for k in STEP_KEYS}
                       if program else {})
            got["sampler_tv"] = check.sampler_tv(alias, corpus.counts,
                                                 seed, draw=uniform,
                                                 probs=probs)
        else:
            fn = (tap.chunk_fn if mode == "program"
                  else faulted(tap.chunk_fn, mode, B))
            tables = [t.clone() for t in r.tables]
            try:
                got.update(check.step_readings(cell.model, cfg, fn, alias,
                                               tables, corpus, seed,
                                               scalars, state=state))
            except NotPlanted as e:
                yield {**head, "mode": mode, "correct": "n/a",
                       "why": str(e), "seconds": time.perf_counter() - t1}
                continue
            finally:
                del tables
            if mode == "program":
                program = got
        judged = {k: v for k, v in got.items() if k in limits}
        checks, correct, failed = check.judge(
            {k: v for k, v in limits.items() if k in judged}, judged)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        yield {**head, "mode": mode, "correct": correct, "failed": failed,
               "compared": sorted(checks),
               "over": sorted(k for k, (v, lim) in checks.items()
                              if not v <= lim),
               **{k: v for k, v in got.items() if k != "leaf_norms"},
               "leaf_norms": got.get("leaf_norms"),
               "seconds": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import run
    run._environment()
    import torch

    from benchmark.cells import benchmark_json, load_cell

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {run._card()}", flush=True)
    cell = load_cell(args.workload, benchmark_json())
    modes = args.modes.split(",")
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for rec in seed_lines(cell, seed, modes, "cuda"):
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
