"""The fused step replayed from a CUDA graph (models/step_graph.py), on the
card: the same tables, losses and kernel launch counts as the eager chunk,
bit for bit, on every route that replays.

Marked `cuda`: without a card each test skips.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph_card.py

(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
does not have; this file does not import it.)  The eager reference is the
same chunk built with `eager_reason` answering that the route stays eager.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain
from word2bits_tpu_torch.data.vocab import Vocab
from word2bits_tpu_torch.kernels import span_scatter
from word2bits_tpu_torch.models import cbow_fused
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.models.cbow_slab import SlabInputs
from word2bits_tpu_torch.models.step_graph import _counted
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  draw_negatives)

pytestmark = pytest.mark.cuda

V, D, B, W, K, G, S = 700, 64, 256, 4, 5, 32, 4
# route -> make_fused_train_chunk options; the benchmark's two cells' routes
# first (wiki: grmw, context kernel, banded; text8: span, two pools)
ROUTES = {
    "grmw-context-banded": dict(scatter_impl="grmw", banded=64,
                                context_pallas=True),
    "span-context-banded": dict(scatter_impl="span", banded=64,
                                context_pallas=True, neg_pool=2),
    "span-banded": dict(scatter_impl="span", banded=64, neg_pool=2),
    "grmw-shifted": dict(scatter_impl="grmw"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_step_graph_card.py there")
    return torch.device("cuda")


def _chunk(opts, eager: bool, monkeypatch):
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    with monkeypatch.context() as m:
        if eager:
            m.setattr(cbow_fused, "eager_reason", lambda *a, **k: "eager")
        return cbow_fused.make_fused_train_chunk(
            hyper, V, B, S, neg_sharing=G, **opts)


def _epoch(dev, seed: int = 0):
    """Epoch arrays of 3 chunks and a short one: ids with -1 padding at
    both ends, sentences of 5 to 40 tokens."""
    rng = np.random.default_rng(seed)
    n = W + 4 * S * B + W
    tokens = rng.integers(1, V, n)
    sents = np.cumsum(rng.random(n) < 1 / 20)
    tokens[:W] = tokens[-W - B // 2:] = -1
    sents[:W] = sents[-W - B // 2:] = -1
    return (torch.from_numpy(tokens).to(dev),
            torch.from_numpy(sents).to(dev))


def _run(chunk, table, dev, atab, injected):
    """The chunks of one case: two drawn from `gen` on int64 epoch arrays,
    two with injected draws on fresh int32 arrays (as benchmark/check.py
    calls), and a short last chunk.  Returns the chunk losses and the
    kernels' launch counts they added."""
    tokens, sents = _epoch(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    before = [fn.launches for fn in _counted()]
    losses = []

    def sc(ci):
        return ChunkScalars(base0=W + ci * S * B, alpha0=0.05,
                            wca_start=ci * 1000.0, wca_per_step=250.0,
                            denom=1e6)

    for ci in range(2):
        losses.append(chunk(table, tokens, sents, atab, sc(ci), gen,
                            n_steps=S)[1])
    for shrinks, negs in injected:
        losses.append(chunk(table, tokens.int().clone(), sents.int().clone(),
                            atab, sc(2), None, n_steps=S, shrinks=shrinks,
                            negs=negs)[1])
    losses.append(chunk(table, tokens, sents, atab, sc(3), gen,
                        n_steps=2)[1])
    torch.cuda.synchronize()
    after = [fn.launches for fn in _counted()]
    return losses, [b - a for a, b in zip(before, after)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(_bits(a), _bits(b))


def _setup(dev, opts):
    torch.manual_seed(0)
    table = (torch.randn(V, 2 * D) * 0.2).to(dev, torch.bfloat16)
    w = np.arange(V, 0, -1, dtype=np.float64) ** 0.75
    atab = build_alias_table(w).to(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    P = opts.get("neg_pool", 1)
    injected = [(torch.randint(0, W, (S, B), generator=gen, device=dev),
                 draw_negatives(gen, atab, (S, B // G, P * K), V))
                for _ in range(2)]
    return table, atab, injected


@pytest.mark.parametrize("route", list(ROUTES))
def test_replay_is_bit_identical_to_eager(card, monkeypatch, route):
    opts = ROUTES[route]
    table, atab, injected = _setup(card, opts)
    got = {}
    for eager in (True, False):
        chunk = _chunk(opts, eager, monkeypatch)
        t = table.clone()
        losses, launches = _run(chunk, t, card, atab, injected)
        got[eager] = (t, losses, launches, chunk.counts)
    (te, le, ne, ce), (tg, lg, ng, cg) = got[True], got[False]
    assert _same(te, tg)
    assert all(_same(a, b) for a, b in zip(le, lg))
    assert ne == ng and sum(ne) > 0
    steps = 4 * S + 2
    assert (ce.replayed, ce.eager) == (0, steps)
    # one capture for the int64 epoch arrays, one for the int32 ones
    assert (cg.replayed, cg.eager) == (steps - 2, 2)
    assert cg.seconds["capture"] > 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_step_has_no_host_sync(card, route):
    """One eager step of the route under sync-debug mode "error": it
    neither waits for the device nor copies from pageable host memory."""
    opts = ROUTES[route]
    table, atab, injected = _setup(card, opts)
    tokens, sents = _epoch(card)
    shrinks, negs = injected[0]
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    slab_t = tokens[:B + 2 * W]
    inputs = SlabInputs(slab_t, sents[:B + 2 * W], shrinks[0], negs[0])
    ids = torch.cat([slab_t.clamp_min(0), negs[0].reshape(-1)])
    plan = cbow_fused.scatter_plan(opts["scatter_impl"], ids, table)
    alpha = torch.full((), 0.05, device=card)
    kw = dict(neg_pool=opts.get("neg_pool", 1), banded=opts.get("banded", 0),
              scatter_impl=opts["scatter_impl"], span_plan=plan,
              context_pallas=opts.get("context_pallas", False))
    cbow_fused.fused_slab_step(table, inputs, alpha, hyper, B, G, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cbow_fused.fused_slab_step(table, inputs, alpha, hyper, B, G, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("route", ["grmw-context-banded",
                                   "span-context-banded"])
def test_replayed_chunk_has_no_host_sync(card, monkeypatch, route):
    """Once the step is captured, a whole chunk call (its draws, alphas
    and plan, the copies and the replays) neither waits for the device nor
    copies from pageable host memory: the host can run ahead of the card."""
    opts = ROUTES[route]
    table, atab, _ = _setup(card, opts)
    tokens, sents = _epoch(card)
    chunk = _chunk(opts, False, monkeypatch)
    gen = torch.Generator(device=card).manual_seed(3)
    sc = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                      wca_per_step=250.0, denom=1e6)
    chunk(table, tokens, sents, atab, sc, gen, n_steps=S)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk(table, tokens, sents, atab, sc, gen, n_steps=S)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (chunk.counts.replayed, chunk.counts.eager) == (2 * S - 1, 1)


def test_step_alphas_on_the_card(card):
    """step_alphas fills its scalars on the card: the bits of the float32
    scalars copied from the host."""
    from word2bits_tpu_torch.models.cbow import step_alphas
    rng = np.random.default_rng(0)
    for _ in range(20):
        denom = float(rng.integers(1, 10) * 10.0 ** rng.integers(5, 10)) + 1
        sc = ChunkScalars(base0=0, alpha0=float(rng.choice([0.025, 0.1])),
                          wca_start=float(rng.random() * denom),
                          wca_per_step=float(rng.random() * 2e4 + 1 / 3),
                          denom=denom)
        f32 = dict(dtype=torch.float32, device=card)
        alpha0 = torch.tensor(sc.alpha0, **f32)
        wca = (torch.tensor(sc.wca_start, **f32) + torch.arange(S, **f32)
               * torch.tensor(sc.wca_per_step, **f32))
        want = torch.maximum(
            alpha0 * (1.0 - wca / torch.tensor(sc.denom, **f32)),
            alpha0 * 1e-4)
        assert _same(step_alphas(sc, S, card), want)


@pytest.mark.parametrize("change", ["table", "workspace"])
def test_recaptures_for_a_new_table_or_workspace(card, monkeypatch, change):
    """A table at a new address, or a regrown scatter workspace, misses
    the graph: the chunk captures again, writes nothing to the old table,
    and stays bit-identical to the eager chunk."""
    opts = ROUTES["grmw-context-banded"]
    table, atab, _ = _setup(card, opts)
    tokens, sents = _epoch(card)
    sc = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                      wca_per_step=250.0, denom=1e6)
    out = {}
    for eager in (True, False):
        chunk = _chunk(opts, eager, monkeypatch)
        gen = torch.Generator(device=card).manual_seed(3)
        first = table.clone()
        chunk(first, tokens, sents, atab, sc, gen, n_steps=S)
        kept = first.clone()
        second = first
        if change == "table":
            second = first.clone()
        else:
            dev = first.device
            part, count = span_scatter.current_workspace(dev)
            span_scatter.workspace(dev, 2 * part.numel(), 2 * count.numel())
        loss = chunk(second, tokens, sents, atab, sc, gen, n_steps=S)[1]
        torch.cuda.synchronize()
        if change == "table":
            assert _same(first, kept)
        out[eager] = (second, loss, chunk.counts)
    (te, le, _), (tg, lg, cg) = out[True], out[False]
    assert _same(te, tg) and _same(le, lg)
    assert (cg.replayed, cg.eager) == (2 * S - 2, 2)


@pytest.mark.parametrize("route", ["grmw-context-banded",
                                   "span-context-banded"])
def test_train_replays_bit_identical(card, monkeypatch, route):
    """train.train on the card: tables, chunk_losses and epoch losses as
    the eager engine's; every step but each call's first replayed."""
    rng = np.random.default_rng(1)
    counts = np.sort(rng.integers(5, 400, V))[::-1].copy()
    counts[0] = 300                      # `</s>`
    vocab = Vocab(words=["</s>"] + [f"w{i}" for i in range(1, V)],
                  counts=counts.astype(np.int64))
    encoded = rng.choice(V - 1, 6 * S * B, p=counts[1:] / counts[1:].sum()
                         ) + 1
    encoded[::23] = 0
    opts = ROUTES[route]
    argv = ["-fused-tables", "1", "-neg-sharing", str(G), "-batch-size",
            str(B), "-steps-per-chunk", str(S), "-size", str(D), "-window",
            str(W), "-negative", str(K), "-dtype", "bfloat16", "-iter", "2",
            "-bitlevel", "1", "-min-count", "1", "-debug", "0",
            "-scatter-impl", opts["scatter_impl"], "-banded-tile",
            str(opts["banded"]), "-context-pallas", "1",
            "-neg-pool", str(opts.get("neg_pool", 1))]
    cfg = tconfig.config_from_argv(argv)
    res = {}
    for eager in (True, False):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(cbow_fused, "eager_reason",
                          lambda *a, **k: "eager")
            res[eager] = ttrain.train(dataclasses.replace(cfg),
                                      vocab=vocab, encoded=encoded,
                                      device="cuda")
    re_, rg = res[True], res[False]
    assert _same(re_.tables[0], rg.tables[0])
    assert re_.chunk_losses == rg.chunk_losses
    assert re_.epoch_losses == rg.epoch_losses
    assert (re_.steps_replayed, re_.steps_eager) == (0, re_.steps)
    assert rg.steps_eager == 1 and rg.steps_replayed == rg.steps - 1
