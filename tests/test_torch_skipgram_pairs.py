"""The port's per-pair skip-gram route (`-neg-per-pair 1`) against the
plain PyTorch reference tests/plain_skipgram.py (CPU).

Seeded random float32 tables, V 60, D 16, B 8, W 2, K 3; slabs with
padding and sentence boundaries, and negatives equal to their center.

Tolerances: the port and the reference compute the same float32 terms
and sum them in another order (batched products against one matmul, the
sorted scatter against index_add_), which moves a table element by a few
float32 ulps of the update (seen: at most 6e-8 absolutely, updates up to
0.04): tables atol 5e-7 a step (2e-6 over a three-step chunk), the loss
rtol 1e-6.  The same step with its arithmetic in bfloat16 is 2e-4 to
7e-4 away (test_bfloat16_arithmetic_fails_the_tolerances).
"""

import dataclasses

import pytest
import torch

from tests import plain_skipgram as ps
from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain
from word2bits_tpu_torch.models import cbow as tcbow
from word2bits_tpu_torch.models import cbow_slab as ts
from word2bits_tpu_torch.models import skipgram as tsg
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  draw_negatives)

V, D, B, W, K = 60, 16, 8, 2, 3
ALPHA = 0.05
STEP_ATOL, CHUNK_ATOL, LOSS_RTOL = 5e-7, 2e-6, 1e-6


def _tables(g):
    return (torch.rand(V, D, generator=g) - 0.5,
            torch.rand(V, D, generator=g) - 0.5)


def _slab(g):
    """(tokens, sents, shrink, negs) of one step: three sentences, the
    last slab position padding, two draws of center 0 equal to it."""
    toks = torch.randint(1, V, (B + 2 * W,), generator=g)
    sents = torch.sort(torch.randint(0, 3, (B + 2 * W,), generator=g)).values
    toks[-1] = sents[-1] = -1
    shrink = torch.randint(0, W, (B,), generator=g)
    negs = torch.randint(1, V, (B, 2 * W * K), generator=g)
    negs[0, :2] = toks[W]
    negs[3, 5] = toks[W + 3]
    return toks, sents, shrink, negs


def _hyper(bitlevel, reg):
    return (tcbow.CBOWHyper(bitlevel=bitlevel, size=D, window=W, negative=K,
                            reg=reg),
            ps.Hyper(bitlevel, D, W, K, B, reg))


def _port_step(u, v, inputs, hk, **kw):
    return tsg.skipgram_slab_step(
        u.clone(), v.clone(), ts.SlabInputs(*inputs), torch.tensor(ALPHA),
        hk, B, neg_per_pair=True, **kw)


@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("bitlevel", [0, 1, 2])
def test_pair_step_matches_plain(bitlevel, reg):
    g = torch.Generator().manual_seed(100 * bitlevel + int(reg * 1e4))
    u, v = _tables(g)
    inputs = _slab(g)
    hk, hp = _hyper(bitlevel, reg)
    tu, tv, tl = _port_step(u, v, inputs, hk)
    ru, rv, rl = ps.table_step(u, v, *inputs, ALPHA, hp)
    assert (rv - v).abs().max() > 1e-3        # the step moved the tables
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
    ru, rv, _ = ps.table_step(u, v, *inputs, ALPHA, hp)
    bu, bv, _ = ps.table_step(u, v, *inputs, ALPHA, hp,
                              compute=torch.bfloat16)
    worst = max(float((bu - ru).abs().max()), float((bv - rv).abs().max()))
    assert worst > 20 * STEP_ATOL


def test_masked_pairs_and_their_draws_change_nothing():
    """Pair oi of center b owns lanes oi*K..oi*K+K-1: redrawing the lanes
    of a masked pair (the padding's, a sentence boundary's) changes
    nothing, redrawing an unmasked pair's lanes changes the tables."""
    g = torch.Generator().manual_seed(3)
    u, v = _tables(g)
    toks, sents, _, negs = _slab(g)
    shrink = torch.zeros(B, dtype=torch.long)       # the whole window
    sents = torch.zeros_like(sents)
    sents[W + 4:] = 1                                # a boundary at b = 4
    toks[-1] = sents[-1] = -1
    hk, _ = _hyper(1, 0.0)
    base = _port_step(u, v, (toks, sents, shrink, negs), hk)
    # center 3 and offset +1 (oi = W) cross the boundary; center B-1 and
    # offset +W (oi = 2W-1) reach the padding
    for b, oi, masked in ((3, W, True), (B - 1, 2 * W - 1, True),
                          (2, W, False)):
        other = negs.clone()
        other[b, oi * K:(oi + 1) * K] = torch.tensor([5, 6, 7])
        got = _port_step(u, v, (toks, sents, shrink, other), hk)
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


def test_pair_chunk_matches_sequential_steps():
    S = 3
    g = torch.Generator().manual_seed(11)
    u, v = _tables(g)
    toks, sents = _epoch(g, S)
    shrinks = torch.randint(0, W, (S, B), generator=g)
    negs = torch.randint(1, V, (S, B, 2 * W * K), generator=g)
    negs[1, 2, :K] = toks[W + B + 2]                 # equal to the center
    hk, hp = _hyper(1, 1e-3)
    sc = tcbow.ChunkScalars(base0=W, alpha0=ALPHA, wca_start=100.0,
                            wca_per_step=B * 10.0, denom=2000.0)
    chunk = tsg.make_skipgram_train_chunk(hk, V, B, S, neg_per_pair=True)
    atab = build_alias_table(torch.ones(V).numpy())
    tu, tv, tl = chunk(u.clone(), v.clone(), toks, sents, atab, sc,
                       n_steps=S, shrinks=shrinks, negs=negs)
    alphas = tcbow.step_alphas(sc, S, "cpu")
    ru, rv, rl = ps.chunk(u, v, toks, sents, W, shrinks, negs, alphas, hp)
    torch.testing.assert_close(tu, ru, atol=CHUNK_ATOL, rtol=0)
    torch.testing.assert_close(tv, rv, atol=CHUNK_ATOL, rtol=0)
    assert float(tl) == pytest.approx(float(rl), rel=LOSS_RTOL)


def test_pair_draws_shape_layout_and_determinism():
    """The chunk draws its shrinks [S, B], then its negatives [S, B, 2W*K]
    through draw_negatives, from its generator; the same seed gives the
    same tables, another seed others."""
    S = 2
    g = torch.Generator().manual_seed(21)
    u, v = _tables(g)
    toks, sents = _epoch(g, S)
    hk, _ = _hyper(1, 0.0)
    sc = tcbow.ChunkScalars(base0=W, alpha0=ALPHA, wca_start=0.0,
                            wca_per_step=B * 1.0, denom=1000.0)
    atab = build_alias_table(torch.arange(V, dtype=torch.float64).numpy())

    def run(seed, **inject):
        chunk = tsg.make_skipgram_train_chunk(hk, V, B, S, neg_per_pair=True)
        gen = torch.Generator().manual_seed(seed)
        out = chunk(u.clone(), v.clone(), toks, sents, atab, sc, gen,
                    n_steps=S, **inject)
        return out

    du, dv, dl = run(5)
    gen = torch.Generator().manual_seed(5)
    shrinks = torch.randint(0, W, (S, B), generator=gen)
    negs = draw_negatives(gen, atab, (S, B, 2 * W * K), V)
    assert negs.shape == (S, B, 2 * W * K)
    iu, iv, il = run(99, shrinks=shrinks, negs=negs)
    assert torch.equal(du, iu) and torch.equal(dv, iv)
    su, sv, _ = run(5)
    assert torch.equal(du, su) and torch.equal(dv, sv)
    ou, ov, _ = run(6)
    assert not torch.equal(dv, ov)


PAIRS = ["-model", "skipgram", "-neg-per-pair", "1"]


@pytest.mark.parametrize("argv,flag", [
    (["-neg-per-pair", "1"], "-model skipgram"),
    (PAIRS + ["-neg-sharing", "4"], "-neg-sharing"),
    (PAIRS + ["-neg-pool", "2"], "-neg-pool"),
    (PAIRS + ["-hot-rows", "10"], "-hot-rows"),
    (PAIRS + ["-neg-dense-hot", "1"], "-neg-dense-hot"),
    (PAIRS + ["-dedup-block", "64"], "-dedup-block"),
    (PAIRS + ["-mesh-shape", "data=2,vocab=1"], "-mesh-shape"),
])
def test_per_pair_config_rejections(argv, flag):
    with pytest.raises(ValueError, match=flag) as e:
        tconfig.config_from_argv(argv)
    assert "-neg-per-pair" in str(e.value)


def test_per_pair_config_fields():
    cfg = tconfig.config_from_argv(PAIRS)
    assert cfg.neg_per_pair and cfg.model == "skipgram"
    assert tconfig.config_from_argv(["-cbow", "0"]).neg_per_pair is False


@pytest.mark.parametrize("argv,lanes", [
    (PAIRS, 2 * W * K),
    (["-model", "skipgram"], K),
    ([], None),
])
def test_train_draws_the_route_s_negatives(tmp_path, argv, lanes,
                                            monkeypatch):
    """train() on the CPU: skip-gram's chunks draw [S, B, lanes]
    negatives through draw_negatives (per pair: 2W*K lanes, per center:
    K), CBOW's engine does not reach skip-gram's draws; the tables stay
    finite."""
    shapes = []

    def spy(gen, atab, shape, v):
        shapes.append(tuple(shape))
        return draw_negatives(gen, atab, shape, v)

    monkeypatch.setattr(tsg, "draw_negatives", spy)
    (tmp_path / "c.txt").write_text("a b c d e f g a b c d e\n" * 40)
    cfg = tconfig.config_from_argv(
        argv + ["-train", str(tmp_path / "c.txt"), "-min-count", "1",
                "-size", str(D), "-window", str(W), "-negative", str(K),
                "-batch-size", str(B), "-steps-per-chunk", "4", "-iter",
                "2", "-debug", "0"])
    res = ttrain.train(cfg, device="cpu")
    assert res.steps > 0
    assert all(torch.isfinite(t).all() for t in res.tables)
    if lanes is None:
        assert shapes == []
        return
    assert shapes and all(s[1:] == (B, lanes) for s in shapes)
    assert sum(s[0] for s in shapes) == res.steps
    assert dataclasses.asdict(cfg)["neg_per_pair"] == (lanes
                                                       == 2 * W * K)
