"""The port's fastText CBOW with position weights (`-model fasttext-cbow`,
models/subword_cbow.py, kernel 12's plain versions in kernels/
pos_context.py) against the plain PyTorch reference
tests/plain_fasttext_cbow.py (CPU).

Seeded random float32 tables: V 60 spelled words (two-letter syllables,
so words share n-grams) and 64 buckets, D 16, B 8, W 2, K 3, n-grams of 3
bytes only (minn = maxn = 3, as the published recipe takes one length);
the position weights d drawn around 1.  Each step's slab holds padding, a
sentence boundary, shrunk windows, a center alone in its sentence (n_t =
0) and draws equal to their center.

Tolerances: the port and the reference compute the same float32 terms
and sum them in another order (the position sum term by term against one
reduction, batched products against matmuls, the sorted scatter against
index_add_), which moves a table element by a few float32 ulps of its
update (seen over 120 seeded steps and 10 chunks: at most 1.2e-7
absolutely on each of u, v and d, updates up to 0.21; the loss 2.3e-7
relatively): every leaf atol 5e-7 a step and 2e-6 over a three-step
chunk, the loss rtol 1e-6.  The same step with its arithmetic in bfloat16
is 4.2e-4 or more away on some leaf over 60 seeds, 840 times the step's
tolerance (test_bfloat16_arithmetic_fails_the_tolerances).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tests import plain_fasttext as pf
from tests import plain_fasttext_cbow as pc
from tests.test_torch_fasttext import spelled
from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain
from word2bits_tpu_torch.data.vocab import subword_rows
from word2bits_tpu_torch.io.vectors import read_vectors
from word2bits_tpu_torch.kernels import pos_context as kpc
from word2bits_tpu_torch.models import cbow as tcbow
from word2bits_tpu_torch.models import cbow_slab as ts
from word2bits_tpu_torch.models import subword_cbow as tsc
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  draw_negatives)

V, NB, D, B, W, K = 60, 64, 16, 8, 2, 3
MINN = MAXN = 3
ALPHA = 0.05
STEP_ATOL, CHUNK_ATOL = 5e-7, 2e-6
LOSS_RTOL = 1e-6
# slab sentences: a boundary inside, center 4 (slab W + 4) alone in its
# sentence (n_t = 0), the last slab position padding
SENTS = [0, 0, 0, 0, 1, 1, 2, 3, 3, 3, 3, -1]


WORDS = spelled(V)


@pytest.fixture(scope="module")
def sub():
    return subword_rows(WORDS, MINN, MAXN, NB)


def _tables(g):
    return (torch.rand(V + NB, D, generator=g) - 0.5,
            torch.rand(V, D, generator=g) - 0.5,
            1.0 + 0.5 * (torch.rand(2 * W, D, generator=g) - 0.5))


def _slab(g):
    """(tokens, sents, shrink, negs) of one step (see SENTS), shrinks
    random, three draws equal to their center."""
    toks = torch.randint(1, V, (B + 2 * W,), generator=g)
    sents = torch.tensor(SENTS)
    toks[-1] = -1
    shrink = torch.randint(0, W, (B,), generator=g)
    negs = torch.randint(1, V, (B, K), generator=g)
    negs[0, :2] = toks[W]                  # center 0's own word
    negs[3, 1] = toks[W + 3]
    return toks, sents, shrink, negs


def _hyper(bitlevel, reg):
    return (tcbow.CBOWHyper(bitlevel=bitlevel, size=D, window=W, negative=K,
                            reg=reg),
            pf.bind(WORDS, MINN, MAXN, NB, "cpu", bitlevel=bitlevel, size=D,
                    window=W, negative=K, batch=B, reg=reg))


def _port_step(tables, inputs, hk, sub):
    u, v, d = (t.clone() for t in tables)
    return tsc.subword_cbow_step(u, v, d, ts.SlabInputs(*inputs),
                                 torch.tensor(ALPHA), hk, B, sub)


def _close(got, want, atol):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=atol, rtol=0)


def test_slab_has_the_edge_cases():
    g = torch.Generator().manual_seed(0)
    inputs = _slab(g)
    _, mask, valid = ts._context_masks(ts.SlabInputs(*inputs), B, W)
    n = mask.sum(dim=1)
    assert valid[4] and n[4] == 0                  # a center alone
    assert not valid[B - 1] or n[B - 1] < 2 * W    # padding at the end
    assert (inputs[3] == inputs[0][W:W + B, None]).sum() >= 3


@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("bitlevel", [0, 1, 2])
def test_step_matches_plain(sub, bitlevel, reg):
    g = torch.Generator().manual_seed(100 * bitlevel + int(reg * 1e4))
    tables = _tables(g)
    inputs = _slab(g)
    hk, hp = _hyper(bitlevel, reg)
    *got, tl = _port_step(tables, inputs, hk, sub)
    *want, rl = pc.table_step(*tables, *inputs, ALPHA, hp, block=3)
    assert (want[0][V:] - tables[0][V:]).abs().max() > 1e-3   # buckets
    assert (want[1] - tables[1]).abs().max() > 1e-3
    assert (want[2] - tables[2]).abs().max() > 1e-3           # d moved
    _close(got, want, STEP_ATOL)
    assert float(tl) == pytest.approx(float(rl), rel=LOSS_RTOL)


@pytest.mark.parametrize("bitlevel", [0, 1, 2])
def test_bfloat16_arithmetic_fails_the_tolerances(bitlevel):
    """The reference with its arithmetic in bfloat16 is outside the
    tolerances that the port keeps."""
    g = torch.Generator().manual_seed(7 + bitlevel)
    tables = _tables(g)
    inputs = _slab(g)
    _, hp = _hyper(bitlevel, 0.0)
    *ref, _ = pc.table_step(*tables, *inputs, ALPHA, hp)
    *low, _ = pc.table_step(*tables, *inputs, ALPHA, hp,
                            compute=torch.bfloat16)
    worst = max(float((a - b).abs().max()) for a, b in zip(low, ref))
    assert worst > 20 * STEP_ATOL


def test_center_without_context_changes_nothing(sub):
    """A center alone in its sentence (n_t = 0) has no hidden vector: its
    word's own rows, its output row and its draws stay as they were, and
    redrawing its negatives changes nothing; another center's do."""
    g = torch.Generator().manual_seed(3)
    tables = _tables(g)
    toks, sents, shrink, negs = _slab(g)
    hk, _ = _hyper(1, 0.0)
    base = _port_step(tables, (toks, sents, shrink, negs), hk, sub)
    for b, masked in ((4, True), (2, False)):
        other = negs.clone()
        other[b] = torch.tensor([5, 6, 7])
        got = _port_step(tables, (toks, sents, shrink, other), hk, sub)
        same = all(torch.equal(x, y) for x, y in zip(base[:3], got[:3]))
        assert same == masked, b


def test_position_weights_scale_the_context(sub):
    """A position that no center's window reaches (every window shrunk to
    1) gets no gradient; the nearest positions do."""
    g = torch.Generator().manual_seed(9)
    tables = _tables(g)
    toks, sents, _, negs = _slab(g)
    shrink = torch.full((B,), W - 1)                # window 1 everywhere
    hk, _ = _hyper(0, 0.0)
    u, v, d, _ = _port_step(tables, (toks, sents, shrink, negs), hk, sub)
    dd = d - tables[2]
    far = [0, 2 * W - 1]                            # offsets -W and +W
    assert not dd[far].any()
    assert dd[[W - 1, W]].abs().max() > 1e-4


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
    tables = _tables(g)
    toks, sents = _epoch(g, S)
    shrinks = torch.randint(0, W, (S, B), generator=g)
    negs = torch.randint(1, V, (S, B, K), generator=g)
    negs[1, 2, :2] = toks[W + B + 2]              # equal to the center
    hk, hp = _hyper(1, 1e-3)
    sc = tcbow.ChunkScalars(base0=W, alpha0=ALPHA, wca_start=100.0,
                            wca_per_step=B * 10.0, denom=2000.0)
    chunk = tsc.make_subword_cbow_train_chunk(hk, V, B, S, sub)
    atab = build_alias_table(np.ones(V))
    *got, tl = chunk(*(t.clone() for t in tables), toks, sents, atab, sc,
                     n_steps=S, shrinks=shrinks, negs=negs)
    alphas = tcbow.step_alphas(sc, S, "cpu")
    *want, rl = pc.chunk(*tables, toks, sents, W, shrinks, negs, alphas, hp)
    _close(got, want, CHUNK_ATOL)
    assert float(tl) == pytest.approx(float(rl), rel=LOSS_RTOL)


def test_chunk_draws_per_center_from_its_generator(sub):
    """The chunk draws its shrinks [S, B], then its negatives [S, B, K]
    through draw_negatives, from its generator: injecting those draws
    gives the same tables; another seed others."""
    S = 2
    g = torch.Generator().manual_seed(21)
    tables = _tables(g)
    toks, sents = _epoch(g, S)
    hk, _ = _hyper(1, 0.0)
    sc = tcbow.ChunkScalars(base0=W, alpha0=ALPHA, wca_start=0.0,
                            wca_per_step=B * 1.0, denom=1000.0)
    atab = build_alias_table(np.arange(V, dtype=np.float64) ** 0.5)

    def run(seed, **inject):
        chunk = tsc.make_subword_cbow_train_chunk(hk, V, B, S, sub)
        gen = torch.Generator().manual_seed(seed)
        return chunk(*(t.clone() for t in tables), toks, sents, atab, sc,
                     gen, n_steps=S, **inject)

    drawn = run(5)
    gen = torch.Generator().manual_seed(5)
    shrinks = torch.randint(0, W, (S, B), generator=gen)
    negs = draw_negatives(gen, atab, (S, B, K), V)
    injected = run(99, shrinks=shrinks, negs=negs)
    assert all(torch.equal(a, b) for a, b in zip(drawn[:3], injected[:3]))
    assert not torch.equal(run(6)[0], drawn[0])


@pytest.mark.parametrize("W_", [1, 2, 5])
def test_pos_context_plain_versions(W_):
    """kernels/pos_context's plain versions against the equations, term
    by term in float64, on random masks and weights."""
    g = torch.Generator().manual_seed(W_)
    Bk, Dk = 13, 7
    x = torch.randn(Bk + 2 * W_, Dk, generator=g)
    d = torch.randn(2 * W_, Dk, generator=g)
    m = (torch.rand(Bk, 2 * W_, generator=g) < 0.6).float()
    m[3] = 0.0
    e = torch.randn(Bk, Dk, generator=g)
    offs = [o for o in range(-W_, W_ + 1) if o != 0]
    h64 = torch.zeros(Bk, Dk, dtype=torch.float64)
    dx64 = torch.zeros(Bk + 2 * W_, Dk, dtype=torch.float64)
    dd64 = torch.zeros(2 * W_, Dk, dtype=torch.float64)
    for b in range(Bk):
        for p, o in enumerate(offs):
            s = W_ + b + o
            h64[b] += m[b, p].double() * d[p].double() * x[s].double()
            dx64[s] += m[b, p].double() * d[p].double() * e[b].double()
            dd64[p] += m[b, p].double() * e[b].double() * x[s].double()
        h64[b] /= max(float(m[b].sum()), 1.0)
    h = kpc.pos_context(x, d, m, W_)
    dx, dd = kpc.pos_context_grad(e, x, d, m, W_)
    torch.testing.assert_close(h.double(), h64, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dx.double(), dx64, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dd.double(), dd64, atol=1e-5, rtol=1e-5)
    assert not h[3].any()


@pytest.mark.parametrize("bad", ["m_width", "x_rows", "d_dtype", "e_rows"])
def test_pos_context_refuses_bad_shapes(bad):
    x, d = torch.zeros(12, 4), torch.ones(4, 4)
    m, e = torch.ones(8, 4), torch.zeros(8, 4)
    if bad == "m_width":
        m = torch.ones(8, 3)
    elif bad == "x_rows":
        x = torch.zeros(11, 4)
    elif bad == "d_dtype":
        d = d.double()
    else:
        e = torch.zeros(7, 4)
    with pytest.raises(ValueError, match="pos_context"):
        kpc.pos_context_grad(e, x, d, m, 2)


FTC = ["-model", "fasttext-cbow"]


@pytest.mark.parametrize("argv,flag", [
    (FTC + ["-neg-per-pair", "1"], "-neg-per-pair"),
    (FTC + ["-neg-sharing", "4"], "-neg-sharing"),
    (FTC + ["-neg-sharing", "4", "-neg-pool", "2"], "-neg-sharing"),
    (FTC + ["-hot-rows", "10", "-neg-dense-hot", "1"], "-hot-rows"),
    (FTC + ["-dedup-block", "64"], "-dedup-block"),
    (FTC + ["-fused-tables", "1", "-neg-sharing", "4"], "-neg-sharing"),
    (FTC + ["-mesh-shape", "data=2,vocab=1"], "-mesh-shape"),
    (FTC + ["-packed", "1"], "-packed"),
    (FTC + ["-context-pallas", "1"], "-context-pallas"),
    (FTC + ["-use-pallas", "1"], "use_pallas"),
    (FTC + ["-banded-tile", "16"], "banded_tile"),
    (FTC + ["-minn", "5", "-maxn", "4"], "-minn"),
    (FTC + ["-bucket", "0"], "-bucket"),
])
def test_config_rejections(argv, flag):
    with pytest.raises(ValueError, match=flag):
        tconfig.config_from_argv(argv)


def test_config_fields():
    cfg = tconfig.config_from_argv(FTC + ["-minn", "5", "-maxn", "5",
                                          "-bucket", "2000000"])
    assert (cfg.model, cfg.minn, cfg.maxn) == ("fasttext-cbow", 5, 5)
    assert cfg.subword_buckets == 2_000_000 and not cfg.fused_on
    assert tconfig.config_from_argv(FTC + ["-maxn", "0"]).subword_buckets \
        == 0


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
        FTC + ["-train", _corpus(tmp_path), "-output",
               str(tmp_path / "v.txt"), "-min-count", "1", "-size", str(D),
               "-window", str(W), "-negative", str(K), "-batch-size",
               str(B), "-steps-per-chunk", "4", "-bucket", str(NB),
               "-minn", str(MINN), "-maxn", str(MAXN), "-debug", "0",
               *extra])


def test_train_runs_the_engine_and_exports_means(tmp_path, monkeypatch):
    """train() on the CPU: the tables are [V + buckets, D], [V, D] and the
    position weights [2W, D] (moved from their ones), the chunks draw
    [S, B, K] negatives, the epoch callback gets all three, and each
    exported vector is the mean of the word's quantized G_w rows: the
    file holds V rows of D and nothing of d."""
    shapes, seen = [], []

    def spy(gen, atab, shape, vs):
        shapes.append(tuple(shape))
        return draw_negatives(gen, atab, shape, vs)

    monkeypatch.setattr(tsc, "draw_negatives", spy)
    cfg = _cfg(tmp_path, "-iter", "2")
    res = ttrain.train(cfg, device="cpu",
                       on_epoch_end=lambda *a: seen.append(a))
    u, v, d = res.tables
    Vw = res.vocab.size
    assert u.shape == (Vw + NB, D) and v.shape == (Vw, D)
    assert d.shape == (2 * W, D) and d.dtype == torch.float32
    assert (d - 1.0).abs().max() > 1e-3
    assert all(torch.isfinite(t).all() for t in res.tables)
    assert shapes and all(s[1:] == (B, K) for s in shapes)
    assert sum(s[0] for s in shapes) == res.steps
    assert [len(a) for a in seen] == [5, 5]
    np.testing.assert_array_equal(seen[-1][3], d.numpy())
    words, vecs = read_vectors(str(tmp_path / "v.txt"))
    assert words == res.vocab.words and vecs.shape == (Vw, D)
    hp = pf.bind(res.vocab.words, MINN, MAXN, NB, "cpu", bitlevel=1, size=D,
                 window=W, negative=K, batch=B)
    want = pf.word_vectors(u, hp, 1).numpy()
    np.testing.assert_allclose(vecs, want, atol=2e-6)


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path,
                                                       monkeypatch):
    """A two-epoch run's checkpoint of epoch 0, resumed, ends with the
    same (u, v, d) as the uninterrupted run, bit for bit; the checkpoint
    holds d, and a checkpoint without it is refused."""
    real = ttrain.save_checkpoint

    def keep_epoch0(path, tables, epoch, gen, words_done):
        real(path, tables, epoch, gen, words_done)
        if epoch == 0:
            shutil.copy(path, tmp_path / "epoch0.npz")

    monkeypatch.setattr(ttrain, "save_checkpoint", keep_epoch0)
    whole = ttrain.train(_cfg(tmp_path, "-iter", "2", "-checkpoint-dir",
                              str(tmp_path / "ck")), device="cpu")
    os.makedirs(tmp_path / "ck2")
    shutil.copy(tmp_path / "epoch0.npz", tmp_path / "ck2" / "state.npz")
    cfg = _cfg(tmp_path, "-iter", "2", "-checkpoint-dir",
               str(tmp_path / "ck2"), "-resume", "1")
    got = ttrain.load_checkpoint(str(tmp_path / "epoch0.npz"), cfg, "cpu")
    assert len(got.tables) == 3 and got.epoch == 0
    assert (got.tables[2] - 1.0).abs().max() > 1e-4
    resumed = ttrain.train(cfg, device="cpu")
    assert resumed.start_epoch == 1
    assert resumed.epoch_losses == whole.epoch_losses[1:]
    for a, b in zip(resumed.tables, whole.tables):
        assert torch.equal(a, b)
    path = str(tmp_path / "two.npz")
    real(path, whole.tables[:2], 0, torch.Generator(), 0.0)
    with pytest.raises(ValueError, match="position weights"):
        ttrain.load_checkpoint(path, cfg, "cpu")
