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


@pytest.mark.parametrize("V,C,N,head,n_sentinel", [
    (320, 128, 700, 0.8, 7), (64, 128, 400, 1.0, 0)])
def test_span_plain_matches_pallas_dominant_head(rng, V, C, N, head,
                                                 n_sentinel):
    """One id holding most rows (80%, beside Zipf ids and drop sentinels)
    or all of them: the Zipf head whose run the kernel cuts into pieces."""
    table, ids, rows = _scatter_case(rng, V, C, N, 0)
    ids[rng.random(N) < head] = 3
    ids[rng.choice(N, n_sentinel, replace=False)] = tspan.SENTINEL
    want = np.asarray(jspan(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(rows), window=64, chunk=32,
                            interpret=True))
    got = tspan.scatter_add_span(torch.from_numpy(table.copy()),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def _bad_span_call(rng, bad):
    """(table, plan, rows) of a scatter that the kernel does not take."""
    V, C, N = 64, 16, 40
    table, ids, rows = _scatter_case(rng, V, C, N, 2)
    table, rows = torch.from_numpy(table), torch.from_numpy(rows)
    plan = tspan.sort_plan(torch.from_numpy(ids).long())
    if bad == "table dtype":
        table = table.double()
    elif bad == "row dtype":
        rows = rows.to(torch.float16)
    elif bad == "bf16 rows into a float32 table":
        rows = rows.to(torch.bfloat16)
    elif bad == "width":
        rows = rows[:, :C - 1]
    elif bad == "batched plan":
        plan = tspan.sort_plan(torch.from_numpy(ids).long()[None])
    elif bad == "plan dtype":
        plan = plan._replace(order=plan.order.long())
    elif bad == "not contiguous":
        rows = torch.from_numpy(np.asfortranarray(rows.numpy()))
    elif bad == "order length":
        plan = plan._replace(order=plan.order[:-1])
    elif bad == "device":
        rows = rows.to("meta")
    return table, plan, rows


@pytest.mark.parametrize("bad", [
    "table dtype", "row dtype", "bf16 rows into a float32 table", "width",
    "batched plan", "plan dtype", "not contiguous", "order length",
    "device"])
def test_span_wrapper_raises_on_what_the_kernel_does_not_take(rng, bad):
    """The checks the wrapper makes before a launch (on a CUDA tensor it
    launches the kernel or raises; it never falls back)."""
    table, plan, rows = _bad_span_call(rng, bad)
    with pytest.raises(ValueError, match="scatter_add_span"):
        tspan.check_sorted("scatter_add_span", table, plan, rows)


def test_span_wrapper_raises_off_cpu_and_cuda(rng):
    table, plan, rows = _bad_span_call(rng, "none")
    meta = [t.to("meta") for t in (table, rows)]
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        tspan.scatter_add_span_planned(meta[0], plan, meta[1])
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        tspan.scatter_add_span_rank1(meta[0], plan, meta[1][:8],
                                     torch.zeros(32, device="meta"),
                                     torch.zeros(8, 16, device="meta"), 4)


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


@pytest.mark.parametrize("dropped", ["sentinels", "negative ids"])
def test_sort_plan_batched_equals_per_step(rng, dropped):
    """The plan of S steps at once is each step's plan, and each step's is
    the stable sort of its ids: ids outside [0, V) stay in it (sentinels
    sort last, negative ids first)."""
    V, S, N = 100, 3, 257
    ids = rng.integers(0, V + 20, (S, N))
    ids[ids >= V] = tspan.SENTINEL if dropped == "sentinels" else -1
    ids_t = torch.from_numpy(ids)
    batched = tspan.sort_plan(ids_t)
    for s in range(S):
        one = tspan.sort_plan(ids_t[s])
        for a, b in zip(batched.step(s), one):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(one.order.numpy(),
                                      np.argsort(ids[s], kind="stable"))
        np.testing.assert_array_equal(ids[s][one.order.numpy()],
                                      one.sids.numpy())


@pytest.mark.parametrize("kernel", [2, 3, 7, 8])
def test_one_sort_plan_drives_every_sorted_kernel(rng, kernel):
    """One sort_plan of Zipf ids with drop sentinels and negative ids
    drives each sorted scatter's entry point (kernels 2, 3, 7 and 8; on
    the CPU their plain versions) to the table of the plain scatter, the
    float64 sum of every in-range row."""
    from word2bits_tpu_torch.kernels.group_rmw import scatter_add_grmw_planned
    from word2bits_tpu_torch.kernels.scatter_pallas import \
        scatter_add_rmw_planned
    V, C, nd, per_src = 200, 24, 40, 4
    N = nd * (1 + per_src)
    table, ids, _ = _scatter_case(rng, V, C, N, 6)
    ids[rng.choice(N, 5, replace=False)] = -3
    dense = rng.normal(size=(nd, C)).astype(np.float32)
    g = rng.normal(size=N - nd).astype(np.float32)
    cavg = rng.normal(size=(nd, C)).astype(np.float32)
    rows = np.concatenate([dense, g[:, None] * cavg[np.arange(N - nd)
                                                    // per_src]])
    plan = tspan.sort_plan(torch.from_numpy(ids))
    got = torch.from_numpy(table.copy())
    if kernel == 3:
        tspan.scatter_add_span_rank1(got, plan, torch.from_numpy(dense),
                                     torch.from_numpy(g),
                                     torch.from_numpy(cavg), per_src)
    else:
        planned = {2: tspan.scatter_add_span_planned,
                   7: scatter_add_grmw_planned,
                   8: scatter_add_rmw_planned}[kernel]
        planned(got, plan, torch.from_numpy(rows))
    want = table.astype(np.float64)
    keep = (ids >= 0) & (ids < V)
    np.add.at(want, ids[keep], rows[keep].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_span_planned_matches_unplanned(rng):
    V, C, N = 128, 32, 400
    table, ids, rows = _scatter_case(rng, V, C, N, 3)
    t1 = tspan.scatter_add_span(torch.from_numpy(table.copy()),
                                torch.from_numpy(ids),
                                torch.from_numpy(rows))
    plan = tspan.sort_plan(torch.from_numpy(ids)[None]).step(0)
    t2 = tspan.scatter_add_span_planned(torch.from_numpy(table.copy()), plan,
                                        torch.from_numpy(rows))
    np.testing.assert_allclose(t2.numpy(), t1.numpy(), atol=1e-5, rtol=1e-6)
