"""The port's split-table slab step and chunk == the JAX package's (CPU).

Same numpy inputs (SlabInputs: slab tokens, sentence ids, window shrinks,
negatives) through both packages.  The JAX Pallas kernels (context, score,
span, rank-1 span) run in interpret mode on tables padded to the JAX span
layout, trimmed for the comparison; the port's wrappers run their plain
versions on CPU tensors.  Tolerances are the JAX suite's own
(tests/test_cbow_slab.py:62-64): tables atol 1e-5, loss rtol 1e-4; the
3-step chunk atol 1e-4 (tests/test_span_scatter.py:274-278).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.models.cbow import CBOWHyper as JHyper
from word2bits_tpu.models.cbow_fused import fused_slab_step as jfused
from word2bits_tpu.models.cbow_slab import SlabInputs as JInputs
from word2bits_tpu.models.cbow_slab import slab_step as jslab
from word2bits_tpu_torch.models import cbow as tcbow
from word2bits_tpu_torch.models import cbow_fused as tf
from word2bits_tpu_torch.models import cbow_slab as ts
from word2bits_tpu_torch.sampling.unigram import build_alias_table

V, D, B, W, K = 300, 16, 64, 3, 5
SPAN = dict(span_window=64, span_chunk=32)   # JAX rows pad to 320


def _case(rng, G, P):
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    toks = rng.integers(1, V, B + 2 * W).astype(np.int32)
    sents = np.sort(rng.integers(0, 5, B + 2 * W)).astype(np.int32)
    toks[-2:] = -1
    sents[-2:] = -1
    shrink = rng.integers(0, W, B).astype(np.int32)
    shape = (B // G, P * K) if G else (B, K)
    negs = rng.integers(1, V, shape).astype(np.int32)
    negs.reshape(-1)[:3] = toks[W:W + 3]         # some skipped negatives
    return u, v, (toks, sents, shrink, negs)


def _jax_slab(u, v, inputs, alpha, hyper, G, P, kw):
    """JAX slab_step; with the span scatter on the padded span layout."""
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    pad = None
    if kw.get("scatter_impl") == "span":
        pad = ((0, (-V) % SPAN["span_window"]), (0, (-D) % 128))
        ju, jv = jnp.pad(ju, pad), jnp.pad(jv, pad)
        kw = dict(kw, **SPAN)
    toks, sents, shrink, negs = inputs
    ji = JInputs(slab_tokens=jnp.asarray(toks), slab_sents=jnp.asarray(sents),
                 shrink=jnp.asarray(shrink), neg_ids=jnp.asarray(negs))
    ou, ov, loss = jslab(ju, jv, ji, jnp.float32(alpha), hyper, B,
                         neg_sharing=G, neg_pool=P, **kw)
    if pad is not None:
        ou, ov = ts.params_from_jax(np.asarray(ou), np.asarray(ov),
                                    dtype=torch.float32, device="cpu",
                                    table_pad=(pad[0][1], pad[1][1]))
        return ou.numpy(), ov.numpy(), float(loss)
    return np.asarray(ou), np.asarray(ov), float(loss)


def _torch_inputs(inputs):
    return ts.SlabInputs(*(torch.from_numpy(a).long() for a in inputs))


# (G, P, banded, reg, bitlevel, jax/port keywords)
CASES = [
    (0, 1, 0, 0.0, 1, {}),                                  # quick start
    (0, 1, 0, 0.01, 0, {}),
    (0, 1, 0, 0.001, 4, dict(scatter_impl="span")),
    (0, 1, 8, 0.0, 2, {}),
    (0, 1, 8, 0.0, 1, dict(scatter_impl="span", context_pallas=True)),
    (0, 1, 8, 0.0, 1, dict(scatter_impl="span", context_pallas=True,
                           span_rank1=True)),               # exact mode
    (0, 1, 0, 0.0, 0, dict(scatter_impl="span", span_rank1=True)),
    (8, 1, 0, 0.0, 1, {}),
    (8, 2, 8, 0.01, 2, dict(use_pallas=True)),
    (8, 4, 8, 0.0, 1, dict(use_pallas=True, context_pallas=True)),
    (8, 2, 8, 0.0, 4, dict(scatter_impl="span")),
    (8, 2, 0, 0.001, 0, {}),
]


@pytest.mark.parametrize("G,P,banded,reg,bitlevel,kw", CASES)
def test_slab_step_matches_jax(rng, G, P, banded, reg, bitlevel, kw):
    u, v, inputs = _case(rng, G, P)
    hk = dict(bitlevel=bitlevel, size=D, window=W, negative=K, reg=reg)
    wu, wv, wloss = _jax_slab(u, v, inputs, 0.05, JHyper(**hk), G, P,
                              dict(kw, banded=banded))
    tu, tv, loss = ts.slab_step(
        torch.from_numpy(u.copy()), torch.from_numpy(v.copy()),
        _torch_inputs(inputs), torch.tensor(0.05), tcbow.CBOWHyper(**hk), B,
        G, neg_pool=P, banded=banded, **kw)
    np.testing.assert_allclose(tu.numpy(), wu, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), wv, atol=1e-5)
    np.testing.assert_allclose(float(loss), wloss, rtol=1e-4, atol=1e-4)


def _equivalent_batch(inputs: ts.SlabInputs):
    offsets, mask, valid = ts._context_masks(inputs, B, W)
    toks = inputs.slab_tokens.clamp_min(0)
    ctx_ids = torch.stack([toks[W + o:W + o + B] for o in offsets], dim=1)
    return tcbow.Batch(centers=toks[W:W + B], ctx_ids=ctx_ids, ctx_mask=mask,
                       neg_ids=inputs.neg_ids, valid=valid)


@pytest.mark.parametrize("bitlevel,reg,banded", [(1, 0.0, 0), (0, 0.01, 0),
                                                 (2, 0.001, 8),
                                                 (4, 0.001, 0)])
def test_slab_step_equals_reference_shaped(rng, bitlevel, reg, banded):
    """The port's slab step == the port's cbow_minibatch_update on the
    equivalent per-(center, context) batch, and that step == the JAX
    package's cbow_minibatch_update."""
    from word2bits_tpu.models.cbow import Batch as JBatch
    from word2bits_tpu.models.cbow import cbow_minibatch_update as jref
    u, v, inputs = _case(rng, 0, 1)
    hk = dict(bitlevel=bitlevel, size=D, window=W, negative=K, reg=reg)
    hyper = tcbow.CBOWHyper(**hk)
    ti = _torch_inputs(inputs)
    u1, v1, l1 = tcbow.cbow_minibatch_update(
        torch.from_numpy(u.copy()), torch.from_numpy(v.copy()),
        _equivalent_batch(ti), torch.tensor(0.05), hyper)
    u2, v2, l2 = ts.slab_step(torch.from_numpy(u.copy()),
                              torch.from_numpy(v.copy()), ti,
                              torch.tensor(0.05), hyper, B, banded=banded)
    np.testing.assert_allclose(u2.numpy(), u1.numpy(), atol=1e-5)
    np.testing.assert_allclose(v2.numpy(), v1.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-4, atol=1e-4)
    jb = JBatch(*(jnp.asarray(t.numpy()) for t in _equivalent_batch(ti)))
    ju, jv, jl = jref(jnp.asarray(u), jnp.asarray(v), jb, jnp.float32(0.05),
                      JHyper(**hk))
    np.testing.assert_allclose(u1.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-4, atol=1e-4)


def _chunk_case(rng, S, G, P):
    n = S * B + 2 * W + 40
    tokens = rng.integers(0, V, n).astype(np.int32)
    tokens[:W] = -1
    sents = (np.arange(n) // 37).astype(np.int32)
    sents[:W] = -1
    shrinks = rng.integers(0, W, (S, B)).astype(np.int64)
    shape = (S, B // G, P * K) if G else (S, B, K)
    negs = rng.integers(1, V, shape).astype(np.int64)
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    sc = tcbow.ChunkScalars(base0=W, alpha0=0.05, wca_start=1000.0,
                            wca_per_step=float(B) * 1.3, denom=3e4)
    return tokens, sents, shrinks, negs, u, v, sc


def _jax_alpha(sc, s):
    wca = jnp.float32(sc.wca_start) + jnp.float32(s) * jnp.float32(
        sc.wca_per_step)
    alpha = jnp.float32(sc.alpha0) * (1.0 - wca / jnp.float32(sc.denom))
    return jnp.maximum(alpha, jnp.float32(sc.alpha0) * 1e-4)


@pytest.mark.parametrize("G,P,banded,kw", [
    (0, 1, 0, {}),                                          # quick start
    (0, 1, 8, dict(scatter_impl="span", context_pallas=True,
                   span_rank1=True)),                       # exact mode
    (8, 2, 8, dict(use_pallas=True, context_pallas=True)),
])
def test_slab_chunk_matches_sequential_jax_steps(rng, G, P, banded, kw):
    """Three steps of the port's chunk on injected draws == three JAX
    slab_step calls at the same float32 LR schedule."""
    S = 3
    tokens, sents, shrinks, negs, u, v, sc = _chunk_case(rng, S, G, P)
    hk = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.0)
    wu, wv, wloss = u, v, 0.0
    for s in range(S):
        lo = sc.base0 + s * B - W
        inputs = (tokens[lo:lo + B + 2 * W], sents[lo:lo + B + 2 * W],
                  shrinks[s].astype(np.int32), negs[s].astype(np.int32))
        wu, wv, l = _jax_slab(wu, wv, inputs, _jax_alpha(sc, s), JHyper(**hk),
                              G, P, dict(kw, banded=banded))
        wloss += l
    chunk = ts.make_slab_train_chunk(tcbow.CBOWHyper(**hk), V, B, S,
                                     neg_sharing=G, neg_pool=P,
                                     banded=banded, **kw)
    tu, tv, loss = chunk(torch.from_numpy(u.copy()),
                         torch.from_numpy(v.copy()),
                         torch.from_numpy(tokens).long(),
                         torch.from_numpy(sents).long(),
                         build_alias_table(np.ones(V)), sc,
                         shrinks=torch.from_numpy(shrinks),
                         negs=torch.from_numpy(negs))
    np.testing.assert_allclose(tu.numpy(), wu, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), wv, atol=1e-4)
    np.testing.assert_allclose(float(loss), wloss, rtol=1e-4, atol=1e-3)


def test_reference_chunk_equals_slab_chunk(rng):
    """make_train_chunk (reference-shaped steps) == the per-center slab
    chunk on the same injected draws, and both draw from the generator
    when no draws are given."""
    S = 2
    tokens, sents, shrinks, negs, u, v, sc = _chunk_case(rng, S, 0, 1)
    hyper = tcbow.CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    args = (torch.from_numpy(tokens).long(), torch.from_numpy(sents).long(),
            build_alias_table(np.ones(V)), sc)
    ref = tcbow.make_train_chunk(hyper, V, B, S)
    slab = ts.make_slab_train_chunk(hyper, V, B, S)
    outs = [fn(torch.from_numpy(u.copy()), torch.from_numpy(v.copy()), *args,
               shrinks=torch.from_numpy(shrinks),
               negs=torch.from_numpy(negs)) for fn in (ref, slab)]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)
    drawn = [slab(torch.from_numpy(u.copy()), torch.from_numpy(v.copy()),
                  *args, torch.Generator().manual_seed(seed))[1]
             for seed in (3, 3, 4)]
    assert torch.equal(drawn[0], drawn[1])
    assert not torch.equal(drawn[0], drawn[2])


def test_slab_rejects_later_slices(rng):
    u, v, inputs = _case(rng, 0, 1)
    args = (torch.from_numpy(u), torch.from_numpy(v), _torch_inputs(inputs),
            0.05, tcbow.CBOWHyper(size=D, window=W, negative=K), B)
    # hot_rows and dedup_block run on the plain scatters, not with span
    for kw, name in ((dict(hot_rows=10, scatter_impl="span"), "hot_rows"),
                     (dict(dedup_block=64, scatter_impl="span"),
                      "dedup_block"),
                     (dict(scatter_impl="grmw"), "scatter_impl"),
                     (dict(use_pallas=True), "use_pallas"),
                     (dict(context_pallas=True), "banded")):
        with pytest.raises(ValueError, match=name):
            ts.slab_step(*args, **kw)


@pytest.mark.parametrize("banded,use_pallas,bitlevel,reg", [
    (8, True, 1, 0.0), (8, True, 2, 0.01), (0, False, 1, 0.0),
    (0, True, 4, 0.001)])
def test_fused_step_matches_jax_pallas_and_shifted(rng, banded, use_pallas,
                                                   bitlevel, reg):
    """fused_slab_step with the score kernel's path (use_pallas) and with
    the shifted-sum windows (banded=0) == the JAX package's."""
    G, P = 8, 2
    u, v, inputs = _case(rng, G, P)
    table = np.concatenate([u, v], axis=1)
    hk = dict(bitlevel=bitlevel, size=D, window=W, negative=K, reg=reg)
    toks, sents, shrink, negs = inputs
    ji = JInputs(slab_tokens=jnp.asarray(toks), slab_sents=jnp.asarray(sents),
                 shrink=jnp.asarray(shrink), neg_ids=jnp.asarray(negs))
    want, wloss = jfused(jnp.asarray(table), ji, jnp.float32(0.05),
                         JHyper(**hk), B, G, neg_pool=P, banded=banded,
                         use_pallas=use_pallas)
    got, loss = tf.fused_slab_step(
        torch.from_numpy(table.copy()), _torch_inputs(inputs),
        torch.tensor(0.05), tcbow.CBOWHyper(**hk), B, G, neg_pool=P,
        banded=banded, use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-4,
                               atol=1e-4)
