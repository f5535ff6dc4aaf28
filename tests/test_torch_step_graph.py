"""The CUDA-graph replay's CPU side (models/step_graph.py, ops/consts.py):
the cached constants are the tensors the ops built per call, bit for bit;
quantize and the sigmoids give what they gave; CPU tables and the routes
listed as eager run the eager loop; and TrainResult's step counts add up.
The replay itself runs on the card: tests/test_torch_step_graph_card.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain
from word2bits_tpu_torch.data.vocab import Vocab
from word2bits_tpu_torch.models import cbow_fused, step_graph
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.ops import consts
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.sigmoid import (MAX_EXP, sigmoid_exact,
                                             sigmoid_lut)
from word2bits_tpu_torch.sampling.unigram import build_alias_table

CPU = torch.device("cpu")
DTYPES = [torch.float32, torch.bfloat16]
VALUES = [1.0, -1.0, 3.0, 0.25, 0.75, 0.0, -0.0, 1e-9, 8.0, 128.0, 1 / 3]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("value", VALUES)
def test_const_is_the_per_call_tensor(value, dtype):
    got = consts.const(value, dtype, CPU)
    assert got.shape == () and got.device == CPU
    assert _same(got, torch.tensor(value, dtype=dtype, device=CPU))
    assert consts.const(value, dtype, CPU) is got


def test_const_keeps_signed_zero_and_tuples_apart():
    assert _bits(consts.const(-0.0, torch.float32, CPU)).item() != 0
    assert _bits(consts.const(0.0, torch.float32, CPU)).item() == 0
    odist = consts.const((4, 3, 2, 1, 1, 2, 3, 4), torch.int64, CPU)
    assert torch.equal(odist, torch.tensor([4, 3, 2, 1, 1, 2, 3, 4]))


def _quantize_per_call(x, bitlevel):
    """ops/quantize.quantize as it built its constants on every call."""
    if bitlevel == 0:
        return x

    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    sign = torch.where(x < 0, c(-1.0), c(1.0))
    mag = torch.abs(x)
    if bitlevel == 1:
        return sign * (c(1.0) / c(3.0))
    if bitlevel == 2:
        return sign * torch.where(mag <= 0.5, c(0.25), c(0.75))
    seg = float(2 ** (bitlevel - 1))
    casted = torch.minimum(torch.floor(mag * seg + 0.5), c(seg))
    return sign * (casted / c(seg))


def _inputs(dtype):
    rng = np.random.default_rng(7)
    edges = [0.0, -0.0, 0.5, -0.5, 0.25, 1.0, -1.0, 6.0, -6.0, 7.5, -7.5,
             1e-30, -1e-30, 3e38, -3e38]
    x = np.concatenate([edges, rng.normal(0, 2, 2000),
                        rng.normal(0, 0.3, 2000)])
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bitlevel", [0, 1, 2, 4, 5, 6, 7, 8])
def test_quantize_unchanged(bitlevel, dtype):
    x = _inputs(dtype)
    assert _same(quantize(x, bitlevel), _quantize_per_call(x, bitlevel))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sigmoids_unchanged(dtype):
    f = _inputs(dtype)

    def c(v):
        return torch.tensor(v, dtype=f.dtype)

    idx = torch.floor((f + MAX_EXP) * 83.0)
    sig = torch.sigmoid((idx / 1000 * 2.0 - 1.0) * MAX_EXP)
    lut = torch.where(f > MAX_EXP, c(1.0),
                      torch.where(f < -MAX_EXP, c(0.0), sig))
    exact = torch.where(f > MAX_EXP, c(1.0),
                        torch.where(f < -MAX_EXP, c(1e-9), torch.sigmoid(f)))
    assert _same(sigmoid_lut(f), lut)
    assert _same(sigmoid_exact(f), exact)


@pytest.mark.parametrize("route, opts", [
    ("add", dict(scatter_impl="add")),
    ("sweep", dict(scatter_impl="sweep")),
    ("use_pallas", dict(scatter_impl="span", use_pallas=True)),
    ("rmw_scatter", dict(scatter_impl="span", rmw_scatter=True)),
    ("dedup_block", dict(scatter_impl="grmw", dedup_block=64)),
    ("hot_rows", dict(scatter_impl="span", hot_rows=16)),
])
def test_eager_routes_are_listed(route, opts):
    """Every route that stays eager says why, from EAGER_ROUTES."""
    impl = opts.pop("scatter_impl")
    why = step_graph.eager_reason(impl, **opts)
    assert why == dict(step_graph.EAGER_ROUTES)[route]


@pytest.mark.parametrize("impl", ["span", "grmw"])
def test_replayable_routes(impl):
    assert step_graph.eager_reason(impl, use_pallas=False, rmw_scatter=False,
                                   dedup_block=0, hot_rows=0) is None


V, D, B, W, K, G, S = 60, 8, 32, 2, 3, 8, 3


@pytest.mark.parametrize("impl, banded, extra", [
    ("span", 8, {}), ("grmw", 8, {"context_pallas": True}), ("grmw", 0, {}),
    ("add", 8, {}), ("add", 8, {"hot_rows": 10}),
])
def test_cpu_tables_run_eagerly(monkeypatch, impl, banded, extra):
    """On a CPU table every route runs the eager loop: the replay is never
    entered and every step counts as eager."""
    def refuse(*a, **k):
        raise AssertionError("a CPU table entered the CUDA graph replay")

    monkeypatch.setattr(step_graph.StepReplay, "run", refuse)
    chunk = cbow_fused.make_fused_train_chunk(
        CBOWHyper(bitlevel=1, size=D, window=W, negative=K), V, B, S,
        neg_sharing=G, banded=banded, scatter_impl=impl, **extra)
    rng = np.random.default_rng(0)
    n = W + 2 * S * B + W
    tokens = torch.from_numpy(rng.integers(1, V, n))
    sents = torch.from_numpy(np.cumsum(rng.random(n) < 0.1))
    table = torch.randn(V, 2 * D) * 0.1
    atab = build_alias_table(np.ones(V))
    gen = torch.Generator().manual_seed(0)
    cold = {}
    if "hot_rows" in extra:
        cold["cold_pos"] = torch.full((n // B + S + 2, 4), -1)
    for ci in range(2):
        sc = ChunkScalars(base0=W + ci * S * B, alpha0=0.05, wca_start=0.0,
                          wca_per_step=B, denom=1e5)
        _, loss = chunk(table, tokens, sents, atab, sc, gen,
                        n_steps=S - ci, **cold)
        assert torch.isfinite(loss)
    assert (chunk.counts.replayed, chunk.counts.eager) == (0, 2 * S - 1)


@pytest.mark.parametrize("argv", [
    ["-fused-tables", "1", "-neg-sharing", "8", "-banded-tile", "16",
     "-scatter-impl", "span"],
    ["-fused-tables", "1", "-neg-sharing", "8", "-banded-tile", "16",
     "-scatter-impl", "grmw", "-context-pallas", "1"],
    ["-fused-tables", "1", "-neg-sharing", "8"],
    ["-fused-tables", "0"],
    ["-model", "skipgram"],
])
def test_train_step_counts_add_up(argv):
    """TrainResult.steps_replayed + steps_eager == steps, whatever the
    engine; on the CPU nothing replays and nothing is captured."""
    rng = np.random.default_rng(3)
    counts = np.sort(rng.integers(3, 60, 40))[::-1].astype(np.int64)
    vocab = Vocab(words=["</s>"] + [f"w{i}" for i in range(1, 40)],
                  counts=counts)
    encoded = rng.integers(0, 40, 1500)
    cfg = tconfig.config_from_argv(argv + [
        "-size", "8", "-window", "2", "-negative", "3", "-iter", "2",
        "-min-count", "1", "-batch-size", "64", "-steps-per-chunk", "4",
        "-debug", "0"])
    res = ttrain.train(cfg, vocab=vocab, encoded=encoded, device="cpu")
    assert res.steps > 0
    assert res.steps_replayed + res.steps_eager == res.steps
    assert res.steps_replayed == 0 and res.seconds["capture"] == 0.0


def _step_alphas_per_call(scalars, S):
    """models/cbow.step_alphas as it built its scalars with torch.tensor."""
    f32 = dict(dtype=torch.float32)
    alpha0 = torch.tensor(scalars.alpha0, **f32)
    wca = (torch.tensor(scalars.wca_start, **f32)
           + torch.arange(S, **f32) * torch.tensor(scalars.wca_per_step,
                                                   **f32))
    alphas = alpha0 * (1.0 - wca / torch.tensor(scalars.denom, **f32))
    return torch.maximum(alphas, alpha0 * 1e-4)


@pytest.mark.parametrize("seed", range(6))
def test_step_alphas_unchanged(seed):
    """step_alphas fills its scalars on the device: the same float32 bits
    as the scalars it copied from the host."""
    from word2bits_tpu_torch.models.cbow import step_alphas
    rng = np.random.default_rng(seed)
    denom = float(rng.integers(1, 10) * 10.0 ** rng.integers(5, 10)) + 1.0
    sc = ChunkScalars(base0=0, alpha0=float(rng.choice([0.025, 0.05, 0.1])),
                      wca_start=float(rng.random() * denom),
                      wca_per_step=float(rng.random() * 2e4 + 1 / 3),
                      denom=denom)
    assert _same(step_alphas(sc, 256, CPU), _step_alphas_per_call(sc, 256))
