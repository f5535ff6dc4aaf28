"""Run-level hold of the port on the CPU: one trained run's analogy
accuracy against the JAX package's spread.

Per-center bitlevel 0, seed 1, on the 30,000-sentence structured corpus
(500 questions, the JAX script's --fast corpus) with the JAX script's
HYPER and 5 epochs, trained by word2bits_tpu_torch/tools/accuracy_parity.py
and scored by the port's evaluator: its accuracy must be at or above the
JAX package's mean - 4 sd there, 77.7±1.1 over seeds 1-3 on the CPU (the
ROADMAP re-anchor; `--jax-floors` below measures them), so 73.3.

    python tests/test_torch_parity.py --jax-floors

trains the JAX package on the same corpus on its CPU backend (5 epochs,
seeds 1-5) for per-center bitlevel 0 and skip-gram bitlevel 1 and prints
each row's accuracies, mean ± sd and mean - 3 sd: the floors of
chip_smoke.py's [parity] phase.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MEAN, JAX_SD = 77.7, 1.1        # seeds 1-3, the JAX package on the CPU
FLOOR = round(JAX_MEAN - 4 * JAX_SD, 1)


def _corpus(d: str):
    from word2bits_tpu_torch.data.structured import structured_corpus
    corpus = os.path.join(d, "structured_fast.txt")
    questions = os.path.join(d, "structured_fast_questions.txt")
    structured_corpus(corpus, questions, n_sentences=30_000,
                      n_questions=500)
    return corpus, questions


def test_per_center_bitlevel0_within_jax_spread(tmp_path):
    from word2bits_tpu_torch.tools import accuracy_parity as AP
    corpus, questions = _corpus(str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))   # small ops: threads only cost
    try:
        out = str(tmp_path / "vec.bin")
        AP.run_port(corpus, out, 0, "per-center", {}, 1, AP.HYPER["iters"],
                    "cpu")
        acc, cov = AP.evaluate(out, questions, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert cov == 100.0
    assert acc >= FLOOR, (acc, FLOOR)


def test_parity_rows_and_pass_rule():
    """The script's rows are ACCEPTANCE.md's, and a row passes when its
    mean lies within the JAX row's mean ± 2 sd."""
    from word2bits_tpu_torch.tools import accuracy_parity as AP
    assert AP.HYPER == dict(size=100, window=5, negative=10, iters=5,
                            min_count=5, sample=1e-3, alpha=0.05)
    assert AP.batch_size(0, "per-center") == 0
    assert AP.batch_size(1, "skipgram") == AP.batch_size(1, "shared-16") == 512
    assert AP.verdict("per-center-b1", [41.5 + 8.6, 41.5 + 8.6])[
        "result"] == "pass"
    assert AP.verdict("per-center-b1", [50.2, 50.2])["result"] == "miss"
    assert AP.verdict("skipgram-b1", [60.0, 70.0, 80.0])["result"] == "pass"
    acceptance = open(os.path.join(REPO, "ACCEPTANCE.md")).read().splitlines()
    for name, (bl, mode, _, jm, js, src) in AP.ROWS.items():
        line = acceptance[int(src.split(":")[1]) - 1]
        assert line.startswith(f"| {bl} | {mode} |"), (name, line)
        assert f"| {jm:.1f}±{js:.1f} |" in line, (name, line)


def _jax_floors(seeds=(1, 2, 3, 4, 5)) -> None:
    import json
    import statistics
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from tools import accuracy_parity as JAP

    with tempfile.TemporaryDirectory() as d:
        corpus, questions = _corpus(d)
        for label, model, bitlevel, bsz in (("per-center", "cbow", 0, 0),
                                            ("skipgram", "skipgram", 1, 512)):
            accs = []
            for seed in seeds:
                out = os.path.join(d, f"{label}_{seed}.bin")
                JAP.run_ours(corpus, out, bitlevel, JAP.HYPER["iters"], 0,
                             seed=seed, model=model, batch_size=bsz)
                accs.append(JAP.evaluate(out, questions)[0])
            m, s = statistics.mean(accs), statistics.stdev(accs)
            print(json.dumps(dict(row=label, bitlevel=bitlevel, seeds=seeds,
                                  accs=accs, mean=m, sd=s,
                                  floor=m - 3 * s)), flush=True)


if __name__ == "__main__":
    if "--jax-floors" in sys.argv:
        _jax_floors()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
