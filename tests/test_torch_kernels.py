"""The port's kernel modules == the JAX Pallas kernels (interpret mode, CPU).

On a CPU tensor each wrapper runs its kernel's plain PyTorch version (the
CUDA kernels run only on the card, where chip_smoke.py holds each against
its plain version).  Tolerances are the JAX suite's own:
fused context atol/rtol 1e-4 with loss rtol 1e-5
(tests/test_context_pallas.py), span scatter atol 1e-4 / rtol 1e-5
(tests/test_span_scatter.py) — float summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.kernels.context_pallas import fused_context_pallas as jctx
from word2bits_tpu.kernels.span_scatter import scatter_add_span as jspan
from word2bits_tpu.ops.windowed import (_tile_windows, build_banded_masks,
                                        pick_tile)
from word2bits_tpu_torch.kernels import context_pallas as tctx
from word2bits_tpu_torch.kernels import span_scatter as tspan


def _context_inputs(rng, V=300, D=16, B=64, W=3, banded=8):
    tile = pick_tile(B, W, banded)
    Nt = B // tile
    slab = rng.normal(scale=0.6, size=(B + 2 * W, 2 * D)).astype(np.float32)
    sents = np.sort(rng.integers(-1, 6, B + 2 * W)).astype(np.int32)
    shrink = rng.integers(0, W, B).astype(np.int32)
    Mb, _, valid = build_banded_masks(jnp.asarray(sents), jnp.asarray(shrink),
                                      B, W, tile)
    uwin3 = np.asarray(_tile_windows(jnp.asarray(slab[:, :D]), Nt, tile, W))
    vc = slab[W:W + B, D:]
    return (uwin3, np.ascontiguousarray(vc), np.asarray(Mb),
            np.asarray(valid, np.float32)[:, None],
            np.full((1, 1), 0.05, np.float32))


@pytest.mark.parametrize("bitlevel", [0, 1, 2, 4, 8])
def test_context_plain_matches_pallas(rng, bitlevel):
    args = _context_inputs(rng)
    want = jctx(*(jnp.asarray(a) for a in args), bitlevel, True)
    got = tctx.fused_context_pallas(*(torch.from_numpy(a) for a in args),
                                    bitlevel)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)


@pytest.mark.parametrize("bitlevel", [0, 1, 2, 4, 8])
def test_context_plain_matches_pallas_any_mask(rng, bitlevel):
    """A non-banded 0/1 mask (~30% ones anywhere in the tile's window, some
    rows empty): the JAX kernel contracts over all F, and so must the
    port (csrc/context.cu reads only the set entries, in any column)."""
    args = list(_context_inputs(rng, B=64, banded=16))
    M = (rng.random(args[2].shape) < 0.3).astype(np.float32)
    M.reshape(-1, M.shape[-1])[::7] = 0.0
    assert M[:, :, :-8].any(axis=1).all()   # ones beyond the band
    args[2] = M
    want = jctx(*(jnp.asarray(a) for a in args), bitlevel, True)
    got = tctx.fused_context_pallas(*(torch.from_numpy(a) for a in args),
                                    bitlevel)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)
    assert float(got[3].sum()) < 64          # the empty rows are inactive


def test_context_wrapper_counts_only_launches(rng):
    args = [torch.from_numpy(a) for a in _context_inputs(rng)]
    before = tctx.fused_context_pallas.launches
    tctx.fused_context_pallas(*args, 1)   # CPU: plain version, no launch
    assert tctx.fused_context_pallas.launches == before


def _scatter_case(rng, V, C, N, n_sentinel):
    table = rng.normal(size=(V, C)).astype(np.float32)
    ids = np.minimum(rng.zipf(1.1, size=N) - 1, V - 1).astype(np.int32)
    ids[rng.choice(N, n_sentinel, replace=False)] = tspan.SENTINEL
    rows = rng.normal(size=(N, C)).astype(np.float32)
    return table, ids, rows


@pytest.mark.parametrize("V,C,N,n_sentinel", [
    (320, 128, 500, 7), (64, 128, 300, 0), (1024, 256, 777, 40)])
def test_span_plain_matches_pallas(rng, V, C, N, n_sentinel):
    """Zipf duplicates plus drop sentinels, f32 table (window 64,
    chunk 32 as in tests/test_context_pallas.py)."""
    table, ids, rows = _scatter_case(rng, V, C, N, n_sentinel)
    want = np.asarray(jspan(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(rows), window=64, chunk=32,
                            interpret=True))
    got = tspan.scatter_add_span(torch.from_numpy(table.copy()),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_span_plain_bf16_one_rounding_per_row(rng):
    """bf16 table: rows round to bf16, sum in f32, one bf16 add per row."""
    V, C, N = 256, 64, 600
    table, ids, rows = _scatter_case(rng, V, C, N, 5)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    want = t16.to(torch.float32).numpy().copy()
    keep = ids < V
    np.add.at(want, ids[keep], torch.from_numpy(rows[keep]).to(
        torch.bfloat16).to(torch.float32).numpy().astype(np.float64)
        .astype(np.float32))
    got = tspan.scatter_add_span(t16, torch.from_numpy(ids),
                                 torch.from_numpy(rows))
    want16 = torch.from_numpy(want).to(torch.bfloat16).to(torch.float32)
    # within one bf16 ulp of the exactly summed result (f32 sum order)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               want16.numpy(), atol=1e-3, rtol=2 ** -7)


def test_span_plan_batched_equals_per_step(rng):
    V, S, N = 100, 3, 257
    ids = rng.integers(0, V + 20, (S, N))
    ids[ids >= V] = tspan.SENTINEL
    ids_t = torch.from_numpy(ids)
    batched = tspan.span_plan(ids_t, V)
    for s in range(S):
        one = tspan.span_plan(ids_t[s], V)
        for a, b in zip(batched.step(s), one):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        # runs cover exactly the in-range ids, one run per distinct id
        p = one
        n = int(p.n_runs)
        starts = p.run_start[:n + 1].numpy()
        valid = np.sort(ids[s][ids[s] < V])
        assert n == len(np.unique(valid))
        assert starts[n] == len(valid)
        run_ids = p.sids.numpy()[starts[:n]]
        np.testing.assert_array_equal(run_ids, np.unique(valid))
        np.testing.assert_array_equal(ids[s][p.order.numpy()],
                                      p.sids.numpy())


def test_span_planned_matches_unplanned(rng):
    V, C, N = 128, 32, 400
    table, ids, rows = _scatter_case(rng, V, C, N, 3)
    t1 = tspan.scatter_add_span(torch.from_numpy(table.copy()),
                                torch.from_numpy(ids),
                                torch.from_numpy(rows))
    plan = tspan.span_plan(torch.from_numpy(ids)[None], V).step(0)
    t2 = tspan.scatter_add_span_planned(torch.from_numpy(table.copy()), plan,
                                        torch.from_numpy(rows))
    np.testing.assert_allclose(t2.numpy(), t1.numpy(), atol=1e-5, rtol=1e-6)
