"""The port's analogy evaluator and `cli accuracy` == the JAX package's
(CPU).

Same vectors and questions through both; the transcripts
(format_report, and the CLI's whole standard output) are compared as
equal strings.  The crafted cases carry exact ties (identical rows: the
first row wins in both), case duplicates (a prediction on a case
duplicate of the answer counts), uncovered questions, a threshold, and the
bf16 scoring branch forced through the module constant in both packages.
"""

import sys

import numpy as np
import pytest

import word2bits_tpu.eval.analogy as JA
from word2bits_tpu import cli as jcli
from word2bits_tpu.io import packed as jpacked
from word2bits_tpu.io import vectors as jvec
import word2bits_tpu_torch.eval.analogy as TA
from word2bits_tpu_torch import cli as tcli


def _toy():
    """KING - MAN + WOMAN ~= QUEEN, WALK : WALKED :: RUN : RAN, with a
    case duplicate of QUEEN and an exact duplicate of RAN (a tie)."""
    words = ["</s>", "man", "woman", "king", "queen", "apple", "orange",
             "walk", "walked", "run", "ran", "Queen", "ran2"]
    rng = np.random.default_rng(0)
    D = 16
    base = {w: rng.normal(0, 0.1, D) for w in words}
    royal, female, past = (rng.normal(0, 1, D) for _ in range(3))
    M = np.stack([
        base["</s>"], base["man"], base["man"] + female, base["man"] + royal,
        base["man"] + royal + female + 0.05,
        base["apple"] + rng.normal(0, 1, D),
        base["orange"] + rng.normal(0, 1, D),
        base["walk"], base["walk"] + past, base["run"], base["run"] + past,
        base["man"] + royal + female,            # "Queen": the best match
        base["run"] + past,                      # "ran2": ties "ran"
    ]).astype(np.float32)
    qs = JA.AnalogyQuestions(
        sections=["family", "s2", "s3", "s4", "s5", "gram-past"],
        questions=[
            (0, "MAN", "WOMAN", "KING", "QUEEN"),
            (0, "WOMAN", "MAN", "QUEEN", "KING"),
            (0, "MAN", "WOMAN", "OOVWORD", "QUEEN"),    # uncovered
            (5, "WALK", "WALKED", "RUN", "RAN"),
            (5, "WALKED", "WALK", "RAN", "RUN"),
            (5, "RUN", "RAN", "WALK", "WALKED"),
            (5, "RUN", "RAN2", "WALK", "WALKED"),
        ])
    return words, M, qs


def _both(words, M, qs, **kw):
    tq = TA.AnalogyQuestions(sections=qs.sections, questions=qs.questions)
    got = TA.format_report(TA.evaluate_analogies(words, M, tq, device="cpu",
                                                 **kw))
    want = JA.format_report(JA.evaluate_analogies(words, M, qs, **kw))
    return got, want


def _crafted(rng, V=3000, D=24, nq=600, sections=8):
    """Random vectors; half the covered answers are the port's CPU
    predictions (so the accuracy is not 0), some words out of range."""
    words = ["</s>"] + [f"w{i}" for i in range(V - 1)]
    M = rng.normal(size=(V, D)).astype(np.float32)
    M[7] = M[5]                          # an exact tie
    M[0] = 0.0                           # a zero row (normalizes to 0)
    abc = rng.integers(1, V, (nq, 3))
    d = rng.integers(1, V + 200, nq)     # some answers out of the vocab
    qs = JA.AnalogyQuestions(sections=[f"sec{i}" for i in range(sections)],
                             questions=[])
    name = lambda i: f"W{i - 1}" if i < V else f"OOV{i}"  # noqa: E731
    for i in range(nq):
        qs.questions.append((i * sections // nq, name(abc[i, 0]),
                             name(abc[i, 1]), name(abc[i, 2]), name(d[i])))
    pred = TA.analogy_predictions(words, M, TA.AnalogyQuestions(
        qs.sections, qs.questions), device="cpu")
    covered = [i for i, q in enumerate(qs.questions)
               if not any(w.startswith("OOV") for w in q[1:])]
    for j, i in enumerate(covered[::2]):
        sec, a, b, c, _ = qs.questions[i]
        qs.questions[i] = (sec, a, b, c, words[pred.best[2 * j]].upper())
    return words, M, qs


@pytest.mark.parametrize("bitlevel", [0, 1, 2])
def test_toy_transcript_matches_jax(bitlevel):
    words, M, qs = _toy()
    got, want = _both(words, M, qs, bitlevel=bitlevel)
    assert got == want
    assert "ACCURACY TOP1: 100.00 %" in got or bitlevel


@pytest.mark.parametrize("threshold", [0, 4, 11, 2000])
@pytest.mark.parametrize("bitlevel", [0, 1])
def test_crafted_transcript_matches_jax(rng, bitlevel, threshold):
    words, M, qs = _crafted(rng)
    got, want = _both(words, M, qs, bitlevel=bitlevel, threshold=threshold)
    assert got == want
    if not threshold and not bitlevel:
        assert "ACCURACY TOP1: 0.00 %" not in got


def test_bf16_branch_matches_jax(rng, monkeypatch):
    """The >2 GB branch (bf16 table, f32 sums) forced on a small table in
    both packages, as tests/test_eval.py forces it."""
    monkeypatch.setattr(JA, "_BF16_TABLE_BYTES", 0)
    monkeypatch.setattr(TA, "_BF16_TABLE_BYTES", 0)
    for words, M, qs in (_toy(), _crafted(rng)):
        got, want = _both(words, M, qs)
        assert got == want


def test_ties_go_to_the_first_row():
    words, M, qs = _toy()
    tq = TA.AnalogyQuestions(qs.sections, qs.questions)
    pred = TA.analogy_predictions(words, M, tq, device="cpu", top2=True)
    # WALK:WALKED::RUN:? — "ran" (row 10) and "ran2" (row 12) tie
    k = [i for i, q in enumerate(pred.quads) if tuple(q[1:4]) == (7, 8, 9)]
    assert pred.best[k[0]] == 10
    assert pred.best_score[k[0]] == pred.second_score[k[0]]
    assert np.all(pred.second_score <= pred.best_score)


def test_load_questions_matches_jax(tmp_path):
    p = tmp_path / "q.txt"
    p.write_text(": capital-common-countries\nathens greece baghdad iraq\n"
                 "bad line\n\n: gram1-adjective-to-adverb\n"
                 "amazing amazingly apparent apparently\n")
    t, j = TA.load_questions(str(p)), JA.load_questions(str(p))
    assert (t.sections, t.questions) == (j.sections, j.questions)


def _write_questions(path, qs):
    lines = []
    for s, name in enumerate(qs.sections):
        lines.append(f": {name}")
        lines += [" ".join(q[1:]).lower() for q in qs.questions if q[0] == s]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("fmt", ["bin", "txt", "pack"])
def test_cli_accuracy_matches_jax(tmp_path, rng, monkeypatch, capsys, fmt):
    """`cli accuracy FILE 0 <threshold> -questions Q` prints the JAX
    package's transcript for a binary, a text and a packed file."""
    words, M, qs = _crafted(rng, V=800, D=16, nq=200)
    vecs = np.where(M < 0, -1, 1) * (np.float32(1) / np.float32(3))
    vecs = vecs.astype(np.float32)
    path = str(tmp_path / f"v.{fmt}")
    if fmt == "pack":
        jpacked.write_packed(path, words, vecs, 1)
    else:
        jvec.write_vectors(path, words, vecs, binary=fmt == "bin")
    qpath = tmp_path / "q.txt"
    _write_questions(qpath, qs)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    outs = []
    for main in (tcli.accuracy_main, jcli.accuracy_main):
        assert main([path, "0", "700", "-questions", str(qpath)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "Questions seen / total:" in outs[0]
    monkeypatch.setattr(sys, "argv", ["cli", "accuracy", path, "1", "0",
                                      "-questions", str(qpath)])
    assert tcli.main() == 0
    assert "ACCURACY TOP1" in capsys.readouterr().out


def test_evaluator_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words, M, qs = _toy()
    with pytest.raises(RuntimeError, match="W2B_FORCE_CPU"):
        TA.evaluate_analogies(words, M, TA.AnalogyQuestions(qs.sections,
                                                            qs.questions))


def test_cli_accuracy_reads_questions_from_stdin(tmp_path, monkeypatch,
                                                 capsys):
    import io
    words, M, qs = _toy()
    path = str(tmp_path / "v.bin")
    jvec.write_vectors(path, words, M, binary=True)
    qpath = tmp_path / "q.txt"
    _write_questions(qpath, qs)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    assert tcli.accuracy_main([path, "0", "0", "-questions",
                               str(qpath)]) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO(qpath.read_text()))
    assert tcli.accuracy_main([path, "0", "0"]) == 0
    assert capsys.readouterr().out == want
