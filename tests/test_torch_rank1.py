"""The port's rank-1 span scatter == the JAX package's (interpret, CPU).

`scatter_add_span_rank1` (whose CPU path is its plain version) against the
JAX package's `scatter_add_span_rank1` run in interpret mode on a table
padded to the JAX span layout and trimmed by `params_from_jax`: atol 1e-4,
rtol 1e-4 as in tests/test_span_scatter.py.  Row k of the trailing block
is g[k] * cavg[k // per_src]; the ids are [dense ids; rank-1 ids] with
Zipf duplicates and drop sentinels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.kernels.span_scatter import scatter_add_span_rank1 as jr1
from word2bits_tpu.kernels.span_scatter import span_plan as jplan
from word2bits_tpu_torch.kernels import span_scatter as tspan
from word2bits_tpu_torch.models.cbow_slab import params_from_jax

SPAN = dict(window=64, chunk=32)


def _case(rng, V, C, nd, per_src, n_sentinel=0):
    nn = nd * per_src
    table = rng.normal(size=(V, C)).astype(np.float32)
    ids = np.minimum(rng.zipf(1.2, size=nd + nn) - 1, V - 1).astype(np.int32)
    if n_sentinel:
        ids[rng.choice(nd + nn, n_sentinel, replace=False)] = tspan.SENTINEL
    dense = rng.normal(size=(nd, C)).astype(np.float32)
    g = rng.normal(scale=0.1, size=nn).astype(np.float32)
    cavg = rng.normal(size=(nd, C)).astype(np.float32)
    return table, ids, dense, g, cavg


@pytest.mark.parametrize("V,C,nd,per_src,n_sentinel", [
    (300, 16, 64, 5, 0), (128, 24, 32, 24, 3), (1000, 40, 16, 1, 0)])
def test_rank1_plain_matches_pallas(rng, V, C, nd, per_src, n_sentinel):
    table, ids, dense, g, cavg = _case(rng, V, C, nd, per_src, n_sentinel)
    vp, cp = (-V) % SPAN["window"], (-C) % 128
    pad = ((0, vp), (0, cp))
    jt = jnp.pad(jnp.asarray(table), pad)
    want = jr1(jt, jplan(jnp.asarray(ids), V + vp, **SPAN),
               jnp.pad(jnp.asarray(dense), ((0, 0), (0, cp))),
               jnp.asarray(g), jnp.pad(jnp.asarray(cavg), ((0, 0), (0, cp))),
               per_src, interpret=True, **SPAN)
    want, _ = params_from_jax(np.asarray(want), np.asarray(want),
                              dtype=torch.float32, device="cpu",
                              table_pad=(vp, cp))
    got = tspan.scatter_add_span_rank1(
        torch.from_numpy(table.copy()), tspan.sort_plan(
            torch.from_numpy(ids).long()), torch.from_numpy(dense),
        torch.from_numpy(g), torch.from_numpy(cavg), per_src)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("V,C,nd,per_src,head", [
    (300, 16, 64, 5, 0.8), (128, 24, 32, 24, 1.0)])
def test_rank1_plain_matches_pallas_dominant_head(rng, V, C, nd, per_src,
                                                  head):
    """One id holding most of the dense and rank-1 rows (80%) or all of
    them."""
    table, ids, dense, g, cavg = _case(rng, V, C, nd, per_src)
    ids[rng.random(ids.size) < head] = 5
    vp, cp = (-V) % SPAN["window"], (-C) % 128
    pad = ((0, vp), (0, cp))
    want = jr1(jnp.pad(jnp.asarray(table), pad),
               jplan(jnp.asarray(ids), V + vp, **SPAN),
               jnp.pad(jnp.asarray(dense), ((0, 0), (0, cp))),
               jnp.asarray(g), jnp.pad(jnp.asarray(cavg), ((0, 0), (0, cp))),
               per_src, interpret=True, **SPAN)
    want, _ = params_from_jax(np.asarray(want), np.asarray(want),
                              dtype=torch.float32, device="cpu",
                              table_pad=(vp, cp))
    got = tspan.scatter_add_span_rank1(
        torch.from_numpy(table.copy()), tspan.sort_plan(
            torch.from_numpy(ids).long()), torch.from_numpy(dense),
        torch.from_numpy(g), torch.from_numpy(cavg), per_src)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rank1_equals_materialized_rows(rng, dtype):
    """The rank-1 rows, formed in float32 and rounded to the table dtype,
    scatter exactly as the same rows materialized."""
    V, C, nd, per_src = 200, 12, 20, 6
    table, ids, dense, g, cavg = _case(rng, V, C, nd, per_src, 4)
    t0 = torch.from_numpy(table).to(dtype)
    plan = tspan.sort_plan(torch.from_numpy(ids).long())
    rows = np.concatenate([dense, g[:, None] * cavg[np.arange(
        nd * per_src) // per_src]])
    want = tspan.scatter_add_span_planned(t0.clone(), plan,
                                          torch.from_numpy(rows))
    got = tspan.scatter_add_span_rank1(t0.clone(), plan,
                                       torch.from_numpy(dense),
                                       torch.from_numpy(g),
                                       torch.from_numpy(cavg), per_src)
    assert torch.equal(got, want)
    before = tspan.scatter_add_span_rank1.launches
    tspan.scatter_add_span_rank1(t0.clone(), plan, torch.from_numpy(dense),
                                 torch.from_numpy(g), torch.from_numpy(cavg),
                                 per_src)
    assert tspan.scatter_add_span_rank1.launches == before  # CPU: no launch


def test_params_from_jax_trims_split_span_padding(rng):
    """The JAX slab engine's span storage (rows to the window, columns to
    128 lanes, zero padding) -> the port's unpadded u and v."""
    V, D, vp, cp = 70, 20, 58, 108
    u = rng.normal(size=(V, D)).astype(np.float32)
    v = rng.normal(size=(V, D)).astype(np.float32)
    pad = ((0, vp), (0, cp))
    tu, tv = params_from_jax(np.pad(u, pad), jnp.asarray(np.pad(v, pad),
                                                         jnp.bfloat16),
                             dtype=torch.float32, device="cpu",
                             table_pad=(vp, cp))
    assert tu.shape == tv.shape == (V, D)
    np.testing.assert_array_equal(tu.numpy(), u)
    np.testing.assert_array_equal(
        tv.numpy(), np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32))
