"""The port's sharded step bodies == the JAX package's on its 8-device CPU
mesh, at the same mesh shapes (CPU).

The same numpy inputs go through the JAX step factories of
parallel/sharded.py, sharded_slab.py and sharded_skipgram.py (shard_map
over the 8 virtual devices, tests/conftest.py) and through the port's,
whose shards run on a LocalMesh in this process.  The port's shards are
gathered back into whole tables (layout undone) and compared with the
JAX result.  Tolerances are the JAX suite's (tests/test_sharded_slab.py:
57-60): tables atol 1e-5, loss rtol 1e-4, atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.models.cbow import CBOWHyper as JHyper
from word2bits_tpu.parallel import layout as jlayout
from word2bits_tpu.parallel import sharded as jsharded
from word2bits_tpu.parallel.mesh import make_mesh as jmesh
from word2bits_tpu.parallel.sharded_skipgram import \
    make_sharded_skipgram_step as jskip
from word2bits_tpu.parallel.sharded_slab import make_sharded_slab_step as jslab
from word2bits_tpu_torch.models.cbow import CBOWHyper
from word2bits_tpu_torch.parallel import layout as tlayout
from word2bits_tpu_torch.parallel.mesh import LocalMesh
from word2bits_tpu_torch.parallel.sharded import (make_sharded_train_step,
                                                  pad_vocab_rows,
                                                  shard_params)
from word2bits_tpu_torch.parallel.sharded_skipgram import \
    make_sharded_skipgram_step
from word2bits_tpu_torch.parallel.sharded_slab import make_sharded_slab_step

B, W, K, V, D, H = 64, 3, 4, 45, 16, 11
ATOL, LOSS_TOL = 1e-5, dict(rtol=1e-4, atol=1e-4)


def _tables(seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    return rng, u, v


def _slab_inputs(seed, rows, lanes, lo=1):
    """(u, v, tokens, sents, shrink, negs): tests/test_sharded_slab.py's
    _setup, negatives drawn from [lo, V)."""
    rng, u, v = _tables(seed)
    toks = rng.integers(1, V, B + 2 * W).astype(np.int32)
    sents = np.sort(rng.integers(0, 5, B + 2 * W)).astype(np.int32)
    toks[:2] = -1
    sents[:2] = -1
    shrink = rng.integers(0, W, B).astype(np.int32)
    negs = rng.integers(lo, V, (rows, lanes)).astype(np.int32)
    negs.reshape(-1)[:3] = toks[W:W + 3]         # some skipped negatives
    return u, v, (toks, sents, shrink, negs)


def _jax(step_factory, mesh_shape, u, v, arrays, layout=None, **kw):
    mesh = jmesh(mesh_shape)
    nv = mesh_shape["vocab"]
    up, vp = jsharded.pad_vocab_rows(u, nv), jsharded.pad_vocab_rows(v, nv)
    if layout is not None:
        up, vp = jlayout.to_layout(up, layout), jlayout.to_layout(vp, layout)
    step = step_factory(mesh, up.shape[0], **kw)
    ud, vd = jsharded.shard_params(jnp.asarray(up), jnp.asarray(vp), mesh)
    ou, ov, loss = step(ud, vd, *(jnp.asarray(a) for a in arrays),
                        jnp.float32(0.05))
    ou, ov = np.asarray(ou), np.asarray(ov)
    if layout is not None:
        ou, ov = jlayout.from_layout(ou, layout), jlayout.from_layout(ov,
                                                                      layout)
    return ou[:V], ov[:V], float(loss)


def _port(step_factory, mesh_shape, u, v, arrays, layout=None, **kw):
    """The port's step on a LocalMesh; whole tables from the shards of
    data row 0, layout undone."""
    mesh = LocalMesh.of(mesh_shape)
    up, vp = pad_vocab_rows(u, mesh.nv), pad_vocab_rows(v, mesh.nv)
    if layout is not None:
        up, vp = tlayout.to_layout(up, layout), tlayout.to_layout(vp, layout)
    step = step_factory(mesh, up.shape[0], **kw)
    args = [torch.from_numpy(a).long() if a.dtype.kind == "i"
            else torch.from_numpy(a) for a in arrays]

    def shard(comm):
        ul, vl = shard_params(up, vp, comm)
        return step(comm, ul, vl, *args, torch.tensor(0.05))

    res = mesh.run(shard)
    losses = {float(r[2]) for r in res}
    assert len(losses) == 1              # the loss is replicated
    ou = torch.cat([res[j][0] for j in range(mesh.nv)]).numpy()
    ov = torch.cat([res[j][1] for j in range(mesh.nv)]).numpy()
    if layout is not None:
        ou, ov = tlayout.from_layout(ou, layout), tlayout.from_layout(ov,
                                                                      layout)
    return ou[:V], ov[:V], losses.pop()


def _close(port, jax_out):
    np.testing.assert_allclose(port[0], jax_out[0], atol=ATOL)
    np.testing.assert_allclose(port[1], jax_out[1], atol=ATOL)
    np.testing.assert_allclose(port[2], jax_out[2], **LOSS_TOL)


@pytest.mark.parametrize("mesh_shape", [{"data": 2, "vocab": 4},
                                        {"data": 4, "vocab": 2}])
def test_sharded_reference_step_matches_jax(mesh_shape):
    """parallel/sharded.py: the reference-shaped step on a (data, vocab)
    mesh, per-center context and negative rows."""
    rng, u, v = _tables(3)
    centers = rng.integers(1, V, B).astype(np.int32)
    ctx = rng.integers(1, V, (B, 2 * W)).astype(np.int32)
    mask = rng.random((B, 2 * W)) < 0.7
    negs = rng.integers(1, V, (B, K)).astype(np.int32)
    negs[:4, 0] = centers[:4]
    valid = rng.random(B) < 0.9
    hk = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    arrays = (centers, ctx, mask, negs, valid)
    want = _jax(lambda m, vp: jsharded.make_sharded_train_step(
        JHyper(**hk), m, vp, B), mesh_shape, u, v, arrays)
    got = _port(lambda m, vp: make_sharded_train_step(
        CBOWHyper(**hk), m, vp, B), mesh_shape, u, v,
        (centers, ctx, mask, negs, valid))
    _close(got, want)


# (mesh, G, P, banded, bitlevel, reg, dense-hot, layout)
SLAB_CASES = [
    ({"data": 8, "vocab": 1}, 0, 1, 0, 1, 0.01, False, False),
    ({"data": 2, "vocab": 4}, 0, 1, 0, 1, 0.01, False, False),
    ({"data": 2, "vocab": 4}, 8, 1, 0, 0, 0.01, False, False),
    ({"data": 4, "vocab": 2}, 16, 1, 0, 2, 0.0, False, False),
    ({"data": 2, "vocab": 4}, 8, 4, 0, 1, 0.01, False, False),   # pools
    ({"data": 4, "vocab": 2}, 8, 2, 8, 1, 0.0, False, False),    # banded
    ({"data": 1, "vocab": 8}, 0, 1, 8, 4, 0.001, False, False),
    ({"data": 2, "vocab": 4}, 8, 1, 0, 1, 0.01, True, False),    # dense-hot
    ({"data": 2, "vocab": 4}, 8, 1, 0, 1, 0.01, True, True),     # + layout
    ({"data": 4, "vocab": 2}, 0, 1, 0, 1, 0.01, True, True),
    ({"data": 1, "vocab": 8}, 0, 1, 0, 1, 0.0, True, False),
]


@pytest.mark.parametrize("mesh_shape,G,P,banded,bl,reg,dense,lay", SLAB_CASES)
def test_sharded_slab_step_matches_jax(mesh_shape, G, P, banded, bl, reg,
                                       dense, lay):
    """parallel/sharded_slab.py, the `add` route: per-center and shared
    negatives, pools (the shard's pool offset), banded windows, dense-hot
    negatives with and without the balanced layout."""
    rows = B // G if G else B
    dh = lay_j = lay_t = None
    lanes = P * K
    if dense:
        from word2bits_tpu_torch.sampling.unigram import \
            build_stratified_tables
        counts = np.random.default_rng(9).integers(1, 50, V)
        kc, w_cold, hot_w = build_stratified_tables(
            counts.astype(np.float64) ** 0.75, H).dense_split(K)
        lanes = P * kc
        nv = mesh_shape["vocab"]
        if lay:
            lay_j = jlayout.make_hot_layout(-(-V // nv) * nv, nv, H)
            lay_t = tlayout.make_hot_layout(-(-V // nv) * nv, nv, H)
            hot_w = tlayout.pad_hot_weights(hot_w, lay_t)
        dh = (w_cold, hot_w)
    u, v, arrays = _slab_inputs(0, rows, lanes, lo=H if dense else 1)
    hk = dict(bitlevel=bl, size=D, window=W, negative=K, reg=reg)
    kw = dict(neg_sharing=G, neg_pool=P, banded=banded, dense_hot=dh)
    want = _jax(lambda m, vp: jslab(JHyper(**hk), m, vp, B, hot_layout=lay_j,
                                    **kw), mesh_shape, u, v, arrays, lay_j)
    got = _port(lambda m, vp: make_sharded_slab_step(
        CBOWHyper(**hk), m, vp, B, hot_layout=lay_t, **kw), mesh_shape, u, v,
        arrays, lay_t)
    _close(got, want)


@pytest.mark.parametrize("mesh_shape,G,P", [
    ({"data": 2, "vocab": 4}, 0, 1),
    ({"data": 2, "vocab": 4}, 8, 4),
    ({"data": 4, "vocab": 2}, 16, 1),
])
def test_sharded_skipgram_step_matches_jax(mesh_shape, G, P):
    """parallel/sharded_skipgram.py: per-center and shared negatives, with
    pools routed by the shard's member offset."""
    rows = B // G if G else B
    u, v, arrays = _slab_inputs(1, rows, P * K)
    hk = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    want = _jax(lambda m, vp: jskip(JHyper(**hk), m, vp, B, neg_sharing=G,
                                    neg_pool=P), mesh_shape, u, v, arrays)
    got = _port(lambda m, vp: make_sharded_skipgram_step(
        CBOWHyper(**hk), m, vp, B, neg_sharing=G, neg_pool=P), mesh_shape,
        u, v, arrays)
    _close(got, want)
