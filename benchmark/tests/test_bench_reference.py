"""The plain reference at a tiny size against a worked example: one step
written out per center and per target in Python floats, as the
reference's C loop reads it (every gradient from the step's starting
rows, each row's updates summed before they are added)."""

import math

import numpy as np
import pytest
import torch

from benchmark import plain
from benchmark import reference as ref


def q(x):
    return (-1.0 if x < 0 else 1.0) / 3.0


def lut(f):
    if f > 6:
        return 1.0
    if f < -6:
        return 0.0
    idx = math.floor((f + 6.0) * 83.0)
    x = (idx / 1000.0 * 2.0 - 1.0) * 6.0
    return 1.0 / (1.0 + math.exp(-x))


def exact(f):
    return 1.0 if f > 6 else (1e-9 if f < -6 else 1 / (1 + math.exp(-f)))


U = {1: [0.1, -0.2], 2: [0.3, 0.4], 3: [0.5, 0.6], 4: [0.7, 0.8]}
V = {1: [0.2, 0.2], 2: [-0.1, 0.3], 3: [0.4, -0.4], 4: [-0.3, -0.6]}
SLAB = [1, 2, 3, 4]          # W = 1: centers 2 and 3
NEGS = [[4], [2]]            # center 3's negative is... 2, its neighbour
ALPHA = 0.5


def worked():
    du = {i: [0.0, 0.0] for i in U}
    dv = {i: [0.0, 0.0] for i in V}
    loss = 0.0
    for b, c in enumerate(SLAB[1:3]):
        ctx = [SLAB[b], SLAB[b + 2]]
        cavg = [sum(q(U[w][d]) for w in ctx) / 2 for d in range(2)]
        neu = [0.0, 0.0]
        for t, label in [(c, 1.0)] + [(n, 0.0) for n in NEGS[b]]:
            if label == 0.0 and t == c:
                continue
            f = sum(cavg[d] * q(V[t][d]) for d in range(2))
            g = (label - lut(f)) * ALPHA
            loss += math.log(exact(f if label else -f))
            for d in range(2):
                neu[d] += g * q(V[t][d])
                dv[t][d] += g * cavg[d]
        for w in ctx:
            for d in range(2):
                du[w][d] += neu[d]
    return du, dv, loss


def test_one_step_against_the_worked_example():
    ids = torch.tensor([1, 2, 3, 4])
    u = torch.tensor([U[i] for i in (1, 2, 3, 4)], dtype=torch.float32)
    v = torch.tensor([V[i] for i in (1, 2, 3, 4)], dtype=torch.float32)
    rows = plain.Rows(ids, u, v, torch.float32)
    hp = ref.Hyper(bitlevel=1, size=2, window=1, negative=1, batch=2)
    loss = ref.step(rows, torch.tensor(SLAB), torch.zeros(4, dtype=torch.long),
                    torch.zeros(2, dtype=torch.long), torch.tensor(NEGS),
                    ALPHA, hp)
    du, dv, want = worked()
    assert float(loss) == pytest.approx(want, rel=1e-6)
    for k, i in enumerate((1, 2, 3, 4)):
        assert rows.u[k].tolist() == pytest.approx(
            [U[i][d] + du[i][d] for d in range(2)], abs=1e-6)
        assert rows.v[k].tolist() == pytest.approx(
            [V[i][d] + dv[i][d] for d in range(2)], abs=1e-6)


def test_half_and_lower_precision_differ():
    ids = torch.tensor([1, 2, 3, 4])
    u = torch.tensor([U[i] for i in (1, 2, 3, 4)])
    v = torch.tensor([V[i] for i in (1, 2, 3, 4)])
    hp = ref.Hyper(bitlevel=1, size=2, window=1, negative=1, batch=2)
    args = (torch.tensor(SLAB), torch.zeros(4, dtype=torch.long),
            torch.zeros(2, dtype=torch.long), torch.tensor(NEGS), ALPHA, hp)
    full = plain.Rows(ids, u, v, torch.float32)
    half = plain.Rows(ids, u, v, torch.float32)
    ref.step(full, *args)
    ref.step(half, *args, half=True)
    assert not torch.equal(full.u, half.u)


def test_shared_negatives_per_center():
    hp = ref.Hyper(bitlevel=1, size=4, window=1, negative=2, batch=8,
                   neg_sharing=4, neg_pool=2)
    negs = torch.arange(2 * 4).reshape(2, 4)      # T = 2 tiles, P*K = 4
    per = ref.per_center_negatives(negs, hp)
    # center b: tile b % 2, member b // 2, pool (b // 2) % 2
    assert per[0].tolist() == [0, 1] and per[1].tolist() == [4, 5]
    assert per[2].tolist() == [2, 3] and per[7].tolist() == [6, 7]


def test_negative_probs_fold_the_sentence_token():
    p = plain.negative_probs(np.array([16, 1, 1], dtype=np.int64))
    assert p[0] == 0.0 and p.sum() == pytest.approx(1.0)
    assert p[1] == pytest.approx(0.5)


def test_slab_arrays_cut_sentences():
    enc = torch.tensor([5, 6, 0, 7, 8, 9, 0, 5], dtype=torch.int32)
    keep = torch.ones(10)
    toks, sents = plain.slab_arrays(enc, keep, torch.zeros(8), 2, 4)
    assert toks.tolist() == [-1, -1, 5, 6, 7, 8, 9, 5]
    assert sents.tolist() == [-1, -1, 0, 0, 1, 1, 1, 2]


def test_reference_negatives_follow_the_draw_distribution():
    counts = np.array([50, 400, 100, 30, 5, 5], dtype=np.int64)
    p = plain.negative_probs(counts)
    gen = torch.Generator().manual_seed(2 ** 31 + 5)
    draws = plain.draw_negatives(gen, plain.negative_cdf(counts, "cpu"),
                                 (200, 1000))
    assert draws.shape == (200, 1000) and draws.dtype == torch.int64
    got = np.bincount(draws.reshape(-1).numpy(), minlength=6) / draws.numel()
    assert got[0] == 0.0
    assert np.abs(got - p).max() < 5e-3


def test_step_alpha_decays_to_its_floor():
    assert plain.step_alpha(0.05, 0.0, 101.0) == pytest.approx(0.05)
    assert plain.step_alpha(0.05, 50.5, 101.0) == pytest.approx(0.025)
    assert plain.step_alpha(0.05, 200.0, 101.0) == pytest.approx(5e-6)


def test_rows_gap_reads_each_element():
    ids = torch.tensor([1, 2])
    f32 = torch.float32
    start = plain.Rows(ids, torch.zeros(2, 2), torch.zeros(2, 2), f32)
    moved = plain.Rows(ids, torch.ones(2, 2), torch.ones(2, 2), f32)
    # the same norms, the update put on other elements: a gap of sqrt(2)
    other = plain.Rows(ids, torch.tensor([[2.0 ** 0.5, 0], [0, 2.0 ** 0.5]]),
                       torch.ones(2, 2), f32)
    assert plain.rows_gap(moved, moved, start) == 0.0
    assert plain.rows_gap(start, moved, start) == pytest.approx(1.0)
    assert plain.rows_gap(other, moved, start) == pytest.approx(
        float(torch.tensor([[2 ** 0.5 - 1, -1.0], [-1.0, 2 ** 0.5 - 1]])
              .norm()) / 2.0)
