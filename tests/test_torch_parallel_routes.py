"""The port's sharded chunk == the JAX package's on its 8-device CPU mesh,
on the routes only the chunk reaches (CPU): kernel 2's span route and
kernel 8's rmw route on local ids, the composed bench-winner flags, and
dense-hot negatives under the balanced layout (CBOW and skip-gram).

The JAX chunk draws its shrinks and negatives from a key
(parallel/chunk.py); the test draws the same numbers from the same keys
with the JAX package's own functions and hands them to the port's chunk,
whose shards run on a LocalMesh (the kernels' plain versions on the CPU;
the JAX Pallas kernels in interpret mode).  The JAX span and rmw routes
store each shard padded for their DMA tiles; the whole tables are
compared, trimmed.  Tolerances are the JAX suite's for these chunks
(tests/test_sharded_span.py:104-109): tables atol 3e-5, loss rtol 1e-4,
atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.models.cbow import CBOWHyper as JHyper
from word2bits_tpu.models.cbow import ChunkScalars as JScalars
from word2bits_tpu.parallel import layout as jlayout
from word2bits_tpu.parallel import sharded as jsharded
from word2bits_tpu.parallel.chunk import make_sharded_chunk as jchunk
from word2bits_tpu.parallel.mesh import make_mesh as jmesh
from word2bits_tpu.parallel.sharded_skipgram import \
    _sharded_skipgram_body as jskip_body
from word2bits_tpu.parallel.sharded_slab import _sharded_slab_body as jbody
from word2bits_tpu.sampling import unigram as jsampling
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.parallel import layout as tlayout
from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
from word2bits_tpu_torch.parallel.mesh import LocalMesh
from word2bits_tpu_torch.parallel.sharded import pad_vocab_rows, shard_params
from word2bits_tpu_torch.parallel.sharded_skipgram import \
    _sharded_skipgram_body
from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  build_stratified_tables)

B, W, K, V, D, H = 32, 3, 4, 61, 16, 11
SW = 16                                # the JAX per-shard sweep window
TOL = dict(atol=3e-5)


def _setup(seed, S):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    n = W + S * B + W
    toks = rng.integers(1, V, n).astype(np.int32)
    sents = np.sort(rng.integers(0, 6, n)).astype(np.int32)
    toks[:2] = -1
    sents[:2] = -1
    weights = rng.integers(1, 50, V).astype(np.float64) ** 0.75
    return u, v, toks, sents, weights


def _jax_draws(key, S, neg_shape, table, dense_lanes=0):
    """The JAX sharded chunk's draws (parallel/chunk.py): per step
    split(key, S)[s] -> (k_neg, k_win)."""
    shrinks, negs = [], []
    for k in jax.random.split(key, S):
        k_neg, k_win = jax.random.split(k)
        shrinks.append(np.asarray(jax.random.randint(k_win, (B,), 0, W,
                                                     dtype=jnp.int32)))
        if dense_lanes:
            negs.append(H + np.asarray(jsampling._alias_draw(
                k_neg, table.prob, table.alias, neg_shape[:-1]
                + (dense_lanes,), table.prob.shape[0])))
        else:
            negs.append(np.asarray(jsampling.draw_negatives(
                k_neg, table, neg_shape, V)))
    return np.stack(shrinks), np.stack(negs)


def _port_chunk(body, mesh_shape, S, u, v, toks, sents, shrinks, negs,
                layout=None, **kw):
    """The port's sharded chunk on a LocalMesh with injected draws;
    whole tables, layout undone, and the loss (equal on every shard)."""
    mesh = LocalMesh.of(mesh_shape)
    up, vp = pad_vocab_rows(u, mesh.nv), pad_vocab_rows(v, mesh.nv)
    if layout is not None:
        up, vp = tlayout.to_layout(up, layout), tlayout.to_layout(vp, layout)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    chunk = make_sharded_chunk(body, hyper, mesh, up.shape[0], V, B, S,
                               hot_layout=layout, **kw)
    scalars = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                           wca_per_step=250.0, denom=1e5)
    atab = build_alias_table(np.ones(V))
    T = torch.from_numpy

    def shard(comm):
        ul, vl = shard_params(up, vp, comm)
        return chunk(comm, ul, vl, T(toks).long(), T(sents).long(), atab,
                     scalars, shrinks=T(shrinks).long(), negs=T(negs).long())

    res = mesh.run(shard)
    assert len({float(r[2]) for r in res}) == 1
    ou = torch.cat([res[j][0] for j in range(mesh.nv)]).numpy()
    ov = torch.cat([res[j][1] for j in range(mesh.nv)]).numpy()
    if layout is not None:
        ou, ov = tlayout.from_layout(ou, layout), tlayout.from_layout(ov,
                                                                      layout)
    return ou[:V], ov[:V], float(res[0][2])


def _jax_chunk(body, mesh_shape, S, u, v, toks, sents, table, key,
               row_mult=1, col_pad=0, layout=None, **kw):
    mesh = jmesh(mesh_shape)
    nv = mesh_shape["vocab"]
    up = jsharded.pad_vocab_rows(u, nv * row_mult)
    vp = jsharded.pad_vocab_rows(v, nv * row_mult)
    if col_pad:
        up, vp = (np.pad(x, ((0, 0), (0, col_pad))) for x in (up, vp))
    if layout is not None:
        up, vp = jlayout.to_layout(up, layout), jlayout.to_layout(vp, layout)
    hyper = JHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    chunk = jchunk(body, hyper, mesh, up.shape[0], V, B, S, donate=False,
                   hot_layout=layout, **kw)
    scalars = JScalars(base0=jnp.int32(W), alpha0=jnp.float32(0.05),
                       wca_start=jnp.float32(0.0),
                       wca_per_step=jnp.float32(250.0),
                       denom=jnp.float32(1e5))
    ud, vd = jsharded.shard_params(jnp.asarray(up), jnp.asarray(vp), mesh)
    ou, ov, loss = chunk(ud, vd, jnp.asarray(toks), jnp.asarray(sents),
                         table.prob, table.alias, scalars, key)
    ou, ov = np.asarray(ou), np.asarray(ov)
    if layout is not None:
        ou, ov = jlayout.from_layout(ou, layout), jlayout.from_layout(ov,
                                                                      layout)
    return ou[:V, :D], ov[:V, :D], float(loss)


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)


# (mesh, G, P, banded, S, route)
ROUTE_CASES = [
    ({"data": 2, "vocab": 4}, 8, 1, 0, 3, "span"),
    ({"data": 1, "vocab": 8}, 8, 1, 0, 2, "span"),    # pure vocab sharding
    ({"data": 2, "vocab": 4}, 0, 1, 0, 2, "span"),    # per-center
    ({"data": 2, "vocab": 4}, 8, 2, 8, 1, "span"),    # the bench winner
    ({"data": 1, "vocab": 8}, 8, 1, 0, 2, "rmw"),     # the capacity layout
    ({"data": 2, "vocab": 4}, 0, 1, 0, 1, "rmw"),
]


@pytest.mark.parametrize("mesh_shape,G,P,banded,S,route", ROUTE_CASES)
def test_row_update_routes_match_jax(mesh_shape, G, P, banded, S, route):
    """The span (kernel 2) and rmw (kernel 8) routes: update lists
    all-gathered over "data", applied per shard on local ids with
    sentinels; steps == 1 is the JAX no-scan path."""
    u, v, toks, sents, weights = _setup(0, S)
    table = jsampling.build_alias_table(weights)
    key = jax.random.PRNGKey(7)
    rows = B // G if G else B
    shrinks, negs = _jax_draws(key, S, (rows, P * K), table)
    kw = dict(neg_sharing=G, neg_pool=P, banded=banded)
    if route == "span":
        jkw = dict(scatter_impl="span", span_window=SW, span_chunk=16,
                   row_mult=SW, col_pad=8)
        tkw = dict(scatter_impl="span")
    else:
        jkw, tkw = dict(rmw=True, row_mult=8), dict(rmw=True)
    want = _jax_chunk(jbody, mesh_shape, S, u, v, toks, sents, table, key,
                      **jkw, **kw)
    got = _port_chunk(_sharded_slab_body, mesh_shape, S, u, v, toks, sents,
                      shrinks, negs, **tkw, **kw)
    _close(got, want)


@pytest.mark.parametrize("mesh_shape,G,model", [
    ({"data": 4, "vocab": 2}, 8, "cbow"),
    ({"data": 2, "vocab": 4}, 0, "cbow"),
    ({"data": 2, "vocab": 4}, 8, "skipgram"),
])
def test_interleaved_dense_hot_chunk_matches_jax(mesh_shape, G, model):
    """Dense-hot negatives under the balanced hot layout (H = 11, not a
    multiple of nv: the zero-weight padded tail), as the JAX suite's
    tests/test_layout.py cases."""
    S = 2
    u, v, toks, sents, weights = _setup(1, S)
    st = jsampling.build_stratified_tables(weights, H)
    kc, w_cold, hot_w = build_stratified_tables(weights, H).dense_split(K)
    key = jax.random.PRNGKey(11)
    rows = B // G if G else B
    shrinks, negs = _jax_draws(key, S, (rows, K), st.cold, dense_lanes=kc)
    nv = mesh_shape["vocab"]
    Vp = -(-V // nv) * nv
    jbody_fn, tbody_fn = ((jskip_body, _sharded_skipgram_body)
                          if model == "skipgram"
                          else (jbody, _sharded_slab_body))
    want = _jax_chunk(jbody_fn, mesh_shape, S, u, v, toks, sents, st.cold,
                      key, layout=jlayout.make_hot_layout(Vp, nv, H),
                      neg_sharing=G, dense_hot=st.dense_split(K),
                      hot_rows=H)
    got = _port_chunk(tbody_fn, mesh_shape, S, u, v, toks, sents, shrinks,
                      negs, layout=tlayout.make_hot_layout(Vp, nv, H),
                      neg_sharing=G, dense_hot=(kc, w_cold, hot_w),
                      hot_rows=H)
    _close(got, want)
