"""The port's subword skip-gram (`-model fasttext`, models/subword.py)
against the plain PyTorch reference tests/plain_fasttext.py (CPU).

Seeded random float32 tables: V 60 spelled words (two-letter syllables,
so words share n-grams) and 64 buckets, D 16, B 8, W 2, K 3, n-grams of
3-6 bytes; slabs with padding and sentence boundaries, and draws equal to
their pair's target (the context word).

Tolerances: the port and the reference compute the same float32 terms
and sum them in another order (batched products against matmuls, the
sorted scatter against index_add_), which moves a table element by a few
float32 ulps of the update (seen: at most 6e-8 absolutely, updates up to
0.15): tables atol 5e-7 a step (2e-6 over a three-step chunk), the loss
rtol 1e-6.  The same step with its arithmetic in bfloat16 is 1.0e-3 to
1.4e-3 away (test_bfloat16_arithmetic_fails_the_tolerances).
"""

import os

import numpy as np
import pytest
import torch

from tests import plain_fasttext as pf
from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain
from word2bits_tpu_torch.data.vocab import Vocab, subword_rows
from word2bits_tpu_torch.io.vectors import read_vectors
from word2bits_tpu_torch.kernels import subword_mean as ksm
from word2bits_tpu_torch.models import cbow as tcbow
from word2bits_tpu_torch.models import cbow_slab as ts
from word2bits_tpu_torch.models import subword as tsw
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  draw_negatives)

V, NB, D, B, W, K = 60, 64, 16, 8, 2, 3
MINN, MAXN = 3, 6
ALPHA = 0.05
STEP_ATOL, CHUNK_ATOL, LOSS_RTOL = 5e-7, 2e-6, 1e-6
SYL = ("ka", "ri", "to", "ne", "su", "mo", "la", "pe")


def spelled(n):
    """`</s>`, then the bijective base-8 numerals of 1..n-1 in syllables."""
    words = ["</s>"]
    for i in range(1, n):
        digits = []
        while i:
            i, r = divmod(i - 1, len(SYL))
            digits.append(SYL[r])
        words.append("".join(reversed(digits)))
    return words


WORDS = spelled(V)


@pytest.fixture(scope="module")
def sub():
    return subword_rows(WORDS, MINN, MAXN, NB)


def _tables(g):
    return (torch.rand(V + NB, D, generator=g) - 0.5,
            torch.rand(V, D, generator=g) - 0.5)


def _slab(g):
    """(tokens, sents, shrink, negs) of one step: three sentences, the
    last slab position padding, three draws equal to their pair's
    context word."""
    toks = torch.randint(1, V, (B + 2 * W,), generator=g)
    sents = torch.sort(torch.randint(0, 3, (B + 2 * W,), generator=g)).values
    toks[-1] = sents[-1] = -1
    shrink = torch.randint(0, W, (B,), generator=g)
    negs = torch.randint(1, V, (B, 2 * W * K), generator=g)
    negs[0, :2] = toks[0]              # center 0, offset -W: slab 0
    negs[3, 3 * K + 1] = toks[W + 3 + 2]   # center 3, offset +2 (oi = 3)
    return toks, sents, shrink, negs


def _hyper(bitlevel, reg):
    return (tcbow.CBOWHyper(bitlevel=bitlevel, size=D, window=W, negative=K,
                            reg=reg),
            pf.bind(WORDS, MINN, MAXN, NB, "cpu", bitlevel=bitlevel, size=D,
                    window=W, negative=K, batch=B, reg=reg))


def _port_step(u, v, inputs, hk, sub):
    return tsw.subword_step(u.clone(), v.clone(), ts.SlabInputs(*inputs),
                            torch.tensor(ALPHA), hk, B, sub)


@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("bitlevel", [0, 1, 2])
def test_step_matches_plain(sub, bitlevel, reg):
    g = torch.Generator().manual_seed(100 * bitlevel + int(reg * 1e4))
    u, v = _tables(g)
    inputs = _slab(g)
    hk, hp = _hyper(bitlevel, reg)
    tu, tv, tl = _port_step(u, v, inputs, hk, sub)
    ru, rv, rl = pf.table_step(u, v, *inputs, ALPHA, hp, block=3)
    assert (ru[V:] - u[V:]).abs().max() > 1e-3   # bucket rows moved
    assert (rv - v).abs().max() > 1e-3
    torch.testing.assert_close(tu, ru, atol=STEP_ATOL, rtol=0)
    torch.testing.assert_close(tv, rv, atol=STEP_ATOL, rtol=0)
    assert float(tl) == pytest.approx(float(rl), rel=LOSS_RTOL)


@pytest.mark.parametrize("bitlevel", [0, 1, 2])
def test_bfloat16_arithmetic_fails_the_tolerances(bitlevel):
    """The reference with its arithmetic in bfloat16 is outside the
    tolerances that the port keeps."""
    g = torch.Generator().manual_seed(7 + bitlevel)
    u, v = _tables(g)
    inputs = _slab(g)
    _, hp = _hyper(bitlevel, 0.0)
    ru, rv, _ = pf.table_step(u, v, *inputs, ALPHA, hp)
    bu, bv, _ = pf.table_step(u, v, *inputs, ALPHA, hp,
                              compute=torch.bfloat16)
    worst = max(float((bu - ru).abs().max()), float((bv - rv).abs().max()))
    assert worst > 20 * STEP_ATOL


def test_duplicate_ngrams_take_the_gradient_twice(sub):
    """A word whose G_w holds a bucket twice (at 64 buckets, two of its
    n-grams hash alike) takes the center's gradient twice there: its
    rows' update is their count times the same gradient."""
    for i in range(1, V):
        g_w = sub.ids[sub.offsets[i]:sub.offsets[i + 1]].tolist()
        reps = {r: g_w.count(r) for r in g_w}
        if sorted(set(reps.values())) == [1, 2]:
            break
    else:
        raise AssertionError("no word holds a bucket twice")
    g = torch.Generator().manual_seed(5)
    u, v = _tables(g)
    toks = torch.full((B + 2 * W,), -1, dtype=torch.long)
    sents = torch.full_like(toks, -1)
    toks[W:W + 2] = torch.tensor([i, 3])
    sents[W:W + 2] = 0
    negs = torch.randint(1, V, (B, 2 * W * K), generator=g)
    hk, _ = _hyper(0, 0.0)
    shrink = torch.zeros(B, dtype=torch.long)
    tu, _, _ = _port_step(u, v, (toks, sents, shrink, negs), hk, sub)
    du = tu - u
    once = [r for r, c in reps.items() if c == 1]
    twice = [r for r, c in reps.items() if c == 2]
    torch.testing.assert_close(du[twice[0]], 2 * du[once[0]], atol=1e-7,
                               rtol=1e-5)
    assert float(du[once[0]].abs().max()) > 1e-4


def test_masked_pairs_and_their_draws_change_nothing(sub):
    """Redrawing the lanes of a masked pair (a sentence boundary's, the
    padding's) changes nothing; an unmasked pair's lanes change the
    tables."""
    g = torch.Generator().manual_seed(3)
    u, v = _tables(g)
    toks, sents, _, negs = _slab(g)
    shrink = torch.zeros(B, dtype=torch.long)
    sents = torch.zeros_like(sents)
    sents[W + 4:] = 1                                # a boundary at b = 4
    toks[-1] = sents[-1] = -1
    hk, _ = _hyper(1, 0.0)
    base = _port_step(u, v, (toks, sents, shrink, negs), hk, sub)
    for b, oi, masked in ((3, W, True), (B - 1, 2 * W - 1, True),
                          (2, W, False)):
        other = negs.clone()
        other[b, oi * K:(oi + 1) * K] = torch.tensor([5, 6, 7])
        got = _port_step(u, v, (toks, sents, shrink, other), hk, sub)
        same = all(torch.equal(x, y) for x, y in zip(base[:2], got[:2]))
        assert same == masked, (b, oi)


def _epoch(g, S):
    """Epoch arrays of S full steps: W padding either side."""
    n = S * B
    toks = torch.full((n + 2 * W,), -1, dtype=torch.long)
    sents = torch.full((n + 2 * W,), -1, dtype=torch.long)
    toks[W:W + n] = torch.randint(1, V, (n,), generator=g)
    sents[W:W + n] = torch.sort(torch.randint(0, 4, (n,), generator=g)).values
    return toks, sents


def test_chunk_matches_sequential_steps(sub):
    S = 3
    g = torch.Generator().manual_seed(11)
    u, v = _tables(g)
    toks, sents = _epoch(g, S)
    shrinks = torch.randint(0, W, (S, B), generator=g)
    negs = torch.randint(1, V, (S, B, 2 * W * K), generator=g)
    negs[1, 2, :K] = toks[W + B + 2 - W]          # equal to the context
    hk, hp = _hyper(1, 1e-3)
    sc = tcbow.ChunkScalars(base0=W, alpha0=ALPHA, wca_start=100.0,
                            wca_per_step=B * 10.0, denom=2000.0)
    chunk = tsw.make_subword_train_chunk(hk, V, B, S, sub)
    atab = build_alias_table(np.ones(V))
    tu, tv, tl = chunk(u.clone(), v.clone(), toks, sents, atab, sc,
                       n_steps=S, shrinks=shrinks, negs=negs)
    alphas = tcbow.step_alphas(sc, S, "cpu")
    ru, rv, rl = pf.chunk(u, v, toks, sents, W, shrinks, negs, alphas, hp)
    torch.testing.assert_close(tu, ru, atol=CHUNK_ATOL, rtol=0)
    torch.testing.assert_close(tv, rv, atol=CHUNK_ATOL, rtol=0)
    assert float(tl) == pytest.approx(float(rl), rel=LOSS_RTOL)


def test_chunk_draws_per_pair_from_its_generator(sub):
    """The chunk draws its shrinks [S, B], then its negatives [S, B,
    2W*K] through draw_negatives, from its generator: injecting those
    draws gives the same tables; another seed others."""
    S = 2
    g = torch.Generator().manual_seed(21)
    u, v = _tables(g)
    toks, sents = _epoch(g, S)
    hk, _ = _hyper(1, 0.0)
    sc = tcbow.ChunkScalars(base0=W, alpha0=ALPHA, wca_start=0.0,
                            wca_per_step=B * 1.0, denom=1000.0)
    atab = build_alias_table(np.arange(V, dtype=np.float64) ** 0.5)

    def run(seed, **inject):
        chunk = tsw.make_subword_train_chunk(hk, V, B, S, sub)
        gen = torch.Generator().manual_seed(seed)
        return chunk(u.clone(), v.clone(), toks, sents, atab, sc, gen,
                     n_steps=S, **inject)

    du, dv, _ = run(5)
    gen = torch.Generator().manual_seed(5)
    shrinks = torch.randint(0, W, (S, B), generator=gen)
    negs = draw_negatives(gen, atab, (S, B, 2 * W * K), V)
    iu, iv, _ = run(99, shrinks=shrinks, negs=negs)
    assert torch.equal(du, iu) and torch.equal(dv, iv)
    ou, ov, _ = run(6)
    assert not torch.equal(du, ou)


@pytest.mark.parametrize("bitlevel", [0, 1, 4])
def test_gather_mean_plain_version(sub, bitlevel):
    """kernels/subword_mean's plain version: the mean of each word's
    quantized G_w rows, as the reference's index_add_ computes it, at
    words in any order and repeated."""
    g = torch.Generator().manual_seed(bitlevel)
    u, _ = _tables(g)
    words = torch.tensor([0, 5, 59, 5, 12, 1])
    got = ksm.subword_mean(u, words, sub, bitlevel)
    hp = pf.bind(WORDS, MINN, MAXN, NB, "cpu", bitlevel=bitlevel, size=D,
                 window=W, negative=K, batch=B)
    want = pf.word_vectors(u, hp, bitlevel)[words]
    torch.testing.assert_close(got, want, atol=1e-7, rtol=0)
    torch.testing.assert_close(got[0], pf.quantize(u[0], bitlevel))
    with pytest.raises(ValueError, match="subword_mean"):
        ksm.subword_mean(u, words.int(), sub, bitlevel)


FT = ["-model", "fasttext"]


@pytest.mark.parametrize("argv,flag", [
    (FT + ["-neg-per-pair", "1"], "-neg-per-pair"),
    (FT + ["-neg-sharing", "4"], "-neg-sharing"),
    (FT + ["-hot-rows", "10", "-neg-dense-hot", "1"], "-hot-rows"),
    (FT + ["-dedup-block", "64"], "-dedup-block"),
    (FT + ["-mesh-shape", "data=2,vocab=1"], "-mesh-shape"),
    (FT + ["-packed", "1"], "-packed"),
    (FT + ["-minn", "4", "-maxn", "3"], "-minn"),
    (FT + ["-bucket", "0"], "-bucket"),
])
def test_config_rejections(argv, flag):
    with pytest.raises(ValueError, match=flag):
        tconfig.config_from_argv(argv)


def test_config_fields():
    cfg = tconfig.config_from_argv(FT + ["-minn", "2", "-maxn", "5",
                                         "-bucket", "1000"])
    assert (cfg.model, cfg.minn, cfg.maxn, cfg.bucket) == ("fasttext", 2, 5,
                                                           1000)
    assert cfg.subword_buckets == 1000
    assert tconfig.config_from_argv(FT + ["-maxn", "0"]).subword_buckets == 0
    default = tconfig.config_from_argv([])
    assert (default.minn, default.maxn, default.bucket) == (3, 6, 2_000_000)
    assert default.subword_buckets == 0


def _corpus(tmp_path):
    g = np.random.default_rng(0)
    words = spelled(40)[1:]
    lines = [" ".join(words[j] for j in g.integers(0, 39, 12))
             for _ in range(120)]
    path = tmp_path / "c.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _cfg(tmp_path, *extra):
    return tconfig.config_from_argv(
        FT + ["-train", _corpus(tmp_path), "-output",
              str(tmp_path / "v.txt"), "-min-count", "1", "-size", str(D),
              "-window", str(W), "-negative", str(K), "-batch-size",
              str(B), "-steps-per-chunk", "4", "-bucket", str(NB),
              "-debug", "0", *extra])


def test_train_runs_the_subword_engine_and_exports_means(tmp_path,
                                                         monkeypatch):
    """train() on the CPU: the tables are [V + buckets, D] and [V, D],
    the chunks draw [S, B, 2W*K] negatives from count^0.5, and each
    exported vector is the mean of the word's quantized G_w rows."""
    shapes = []

    def spy(gen, atab, shape, vs):
        shapes.append(tuple(shape))
        return draw_negatives(gen, atab, shape, vs)

    monkeypatch.setattr(tsw, "draw_negatives", spy)
    cfg = _cfg(tmp_path, "-iter", "2")
    res = ttrain.train(cfg, device="cpu")
    u, v = res.tables
    Vw = res.vocab.size
    assert u.shape == (Vw + NB, D) and v.shape == (Vw, D)
    assert all(torch.isfinite(t).all() for t in res.tables)
    assert shapes and all(s[1:] == (B, 2 * W * K) for s in shapes)
    assert sum(s[0] for s in shapes) == res.steps
    words, vecs = read_vectors(str(tmp_path / "v.txt"))
    assert words == res.vocab.words
    hp = pf.bind(res.vocab.words, MINN, MAXN, NB, "cpu", bitlevel=1, size=D,
                 window=W, negative=K, batch=B)
    want = pf.word_vectors(u, hp, 1).numpy()
    np.testing.assert_allclose(vecs, want, atol=2e-6)


def test_count_half_power_alias_table():
    """The engine's alias table draws from count^0.5."""
    counts = np.array([3, 100, 25, 4, 1], dtype=np.int64)
    vocab = Vocab(words=spelled(5), counts=counts)
    cfg = tconfig.config_from_argv(FT + ["-size", "4", "-window", "1",
                                         "-bucket", "8", "-batch-size",
                                         "2"])
    tables = ttrain.init_tables(cfg, vocab.size, "cpu")
    eng = ttrain.build_engine(cfg, vocab, tables, tcbow.CBOWHyper(
        bitlevel=1, size=4, window=1, negative=5))
    want = build_alias_table(counts.astype(np.float64) ** 0.5)
    assert torch.equal(eng.alias.prob, want.prob)
    assert eng.subwords.rows == 5 + 8 == tables[0].shape[0]


def test_checkpoint_resume_keeps_the_bucket_rows(tmp_path):
    """-checkpoint-dir writes u with its bucket rows; -resume 1 reads
    both tables back in their own shapes."""
    ck = str(tmp_path / "ck")
    cfg = _cfg(tmp_path, "-iter", "1", "-checkpoint-dir", ck)
    res = ttrain.train(cfg, device="cpu")
    got = ttrain.load_checkpoint(os.path.join(ck, "state.npz"), cfg, "cpu")
    assert got.vocab_rows == res.vocab.size
    assert torch.equal(got.tables[0], res.tables[0])
    assert torch.equal(got.tables[1], res.tables[1])
    cfg2 = _cfg(tmp_path, "-iter", "2", "-checkpoint-dir", ck, "-resume",
                "1")
    res2 = ttrain.train(cfg2, device="cpu")
    assert res2.start_epoch == 1 and res2.tables[0].shape[0] == (
        res.vocab.size + NB)
