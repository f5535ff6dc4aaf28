"""The port's fused-table step and chunk == the JAX package's (CPU).

Same numpy inputs (SlabInputs: slab tokens, sentence ids, window shrinks,
shared negatives) through both.  The JAX Pallas kernels run in interpret
mode, as their own tests run them; the port's wrappers run their plain
versions on CPU tensors.  Tolerances follow tests/test_context_pallas.py:
tables atol/rtol 1e-4, loss rtol 1e-5 (atol 1e-3 on sums near zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.models.cbow import CBOWHyper as JHyper
from word2bits_tpu.models.cbow_fused import fused_slab_step as jstep
from word2bits_tpu.models.cbow_slab import SlabInputs as JInputs
from word2bits_tpu_torch.models import cbow_fused as tf
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.models.cbow_slab import SlabInputs
from word2bits_tpu_torch.sampling.unigram import build_alias_table

V, D, B, W, K, G = 300, 16, 64, 3, 5, 8
SPAN = dict(window=64, chunk=32)   # JAX span geometry: rows pad to 320


def _step_case(rng, P):
    table = rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(np.float32)
    toks = rng.integers(-1, V, B + 2 * W).astype(np.int32)
    toks[rng.integers(0, B + 2 * W, 6)] = -1
    sents = np.sort(rng.integers(-1, 5, B + 2 * W)).astype(np.int32)
    shrink = rng.integers(0, W, B).astype(np.int32)
    negs = rng.integers(1, V, (B // G, P * K)).astype(np.int32)
    return table, toks, sents, shrink, negs


def _jax_step(table, toks, sents, shrink, negs, alpha, hyper, P, simpl,
              ctx):
    jt = jnp.asarray(table)
    kw = {}
    if simpl == "span":
        cp, vp = (-2 * D) % 128, (-V) % SPAN["window"]
        jt = jnp.pad(jt, ((0, vp), (0, cp)))
        kw = dict(col_pad=cp, span_window=SPAN["window"],
                  span_chunk=SPAN["chunk"])
    inputs = JInputs(slab_tokens=jnp.asarray(toks),
                     slab_sents=jnp.asarray(sents),
                     shrink=jnp.asarray(shrink), neg_ids=jnp.asarray(negs))
    out, loss = jstep(jt, inputs, jnp.float32(alpha), hyper, B, G,
                      neg_pool=P, banded=8, scatter_impl=simpl,
                      context_pallas=ctx, **kw)
    return np.asarray(out)[:V, :2 * D], float(loss)


def _torch_inputs(toks, sents, shrink, negs):
    return SlabInputs(slab_tokens=torch.from_numpy(toks).long(),
                      slab_sents=torch.from_numpy(sents).long(),
                      shrink=torch.from_numpy(shrink).long(),
                      neg_ids=torch.from_numpy(negs).long())


@pytest.mark.parametrize("bitlevel,P,simpl,ctx,reg", [
    (1, 2, "span", True, 0.0),     # the shipped configuration's step
    (1, 1, "span", True, 0.0),
    (2, 2, "add", True, 0.0),
    (1, 2, "span", False, 0.0),
    (4, 2, "add", False, 0.0),
    (0, 1, "add", False, 0.01),    # reg terms on the non-kernel path
])
def test_fused_step_matches_jax(rng, bitlevel, P, simpl, ctx, reg):
    table, toks, sents, shrink, negs = _step_case(rng, P)
    hyper_kw = dict(bitlevel=bitlevel, size=D, window=W, negative=K, reg=reg)
    want, wloss = _jax_step(table, toks, sents, shrink, negs, 0.05,
                            JHyper(**hyper_kw), P, simpl, ctx)
    got, loss = tf.fused_slab_step(
        torch.from_numpy(table.copy()), _torch_inputs(toks, sents, shrink,
                                                      negs),
        torch.tensor(0.05), CBOWHyper(**hyper_kw), B, G, neg_pool=P,
        banded=8, scatter_impl=simpl, context_pallas=ctx)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss), wloss, rtol=1e-5, atol=1e-3)


def test_fused_step_rejects_unported_paths(rng):
    table, toks, sents, shrink, negs = _step_case(rng, 1)
    args = (torch.from_numpy(table), _torch_inputs(toks, sents, shrink, negs),
            0.05, CBOWHyper(bitlevel=1, size=D, window=W, negative=K), B)
    with pytest.raises(ValueError, match="neg_sharing"):
        tf.fused_slab_step(*args, 0, banded=8)
    with pytest.raises(ValueError, match="banded"):
        tf.fused_slab_step(*args, G, context_pallas=True)
    with pytest.raises(ValueError, match="use_pallas"):
        tf.fused_slab_step(*args, G, banded=8, scatter_impl="span",
                           use_pallas=True)
    hyper_r = CBOWHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.1)
    with pytest.raises(ValueError, match="reg"):
        tf.fused_slab_step(args[0], args[1], 0.05, hyper_r, B, G, banded=8,
                           context_pallas=True)


@pytest.mark.parametrize("simpl,ctx", [("span", True), ("add", False)])
def test_chunk_matches_sequential_jax_steps(rng, simpl, ctx):
    """The port's chunk on injected per-step draws (S=3) == three JAX
    fused_slab_step calls at the same float32 LR schedule."""
    S, P = 3, 2
    hyper_kw = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.0)
    n = S * B + 2 * W + 40
    tokens = rng.integers(0, V, n).astype(np.int32)
    tokens[:W] = -1
    sents = (np.arange(n) // 37).astype(np.int32)
    sents[:W] = -1
    shrinks = rng.integers(0, W, (S, B)).astype(np.int64)
    negs = rng.integers(1, V, (S, B // G, P * K)).astype(np.int64)
    table = rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(np.float32)
    sc = ChunkScalars(base0=W, alpha0=0.05, wca_start=1000.0,
                      wca_per_step=float(B) * 1.3, denom=3e4)

    want, wloss = table, 0.0
    for s in range(S):
        wca = jnp.float32(sc.wca_start) + jnp.float32(s) * jnp.float32(
            sc.wca_per_step)
        alpha = jnp.float32(sc.alpha0) * (1.0 - wca / jnp.float32(sc.denom))
        alpha = jnp.maximum(alpha, jnp.float32(sc.alpha0) * 1e-4)
        lo = sc.base0 + s * B - W
        want, l = _jax_step(want, tokens[lo:lo + B + 2 * W],
                            sents[lo:lo + B + 2 * W], shrinks[s], negs[s],
                            alpha, JHyper(**hyper_kw), P, simpl, ctx)
        wloss += l

    chunk = tf.make_fused_train_chunk(CBOWHyper(**hyper_kw), V, B, S,
                                      neg_sharing=G, neg_pool=P, banded=8,
                                      scatter_impl=simpl,
                                      context_pallas=ctx)
    atab = build_alias_table(np.ones(V))
    got, loss = chunk(torch.from_numpy(table.copy()),
                      torch.from_numpy(tokens).long(),
                      torch.from_numpy(sents).long(), atab, sc,
                      shrinks=torch.from_numpy(shrinks),
                      negs=torch.from_numpy(negs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss), wloss, rtol=1e-5, atol=1e-3)


def test_chunk_draws_from_generator(rng):
    """Without injected draws the chunk samples from its generator: the
    same seed gives the same table, another seed another."""
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    chunk = tf.make_fused_train_chunk(hyper, V, B, 2, neg_sharing=G,
                                      neg_pool=2, banded=8,
                                      scatter_impl="span",
                                      context_pallas=True)
    n = 2 * B + 2 * W
    tokens = torch.from_numpy(rng.integers(0, V, n)).long()
    sents = torch.zeros(n, dtype=torch.long)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, 2 * D))
                             .astype(np.float32))
    atab = build_alias_table(np.arange(1, V + 1, dtype=np.float64))
    sc = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                      wca_per_step=float(B), denom=1e5)
    outs = [chunk(table.clone(), tokens, sents, atab, sc,
                  torch.Generator().manual_seed(seed))[0]
            for seed in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="outside"):
        chunk(table.clone(), tokens[:B], sents[:B], atab, sc,
              torch.Generator().manual_seed(0))


def test_interleave_roundtrip(rng):
    u = torch.from_numpy(rng.uniform(-1, 1, (10, 8)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 1, (10, 8)).astype(np.float32))
    u2, v2 = tf.deinterleave(tf.interleave(u, v))
    assert torch.equal(u2, u) and torch.equal(v2, v)


def test_params_from_jax_roundtrip_padded_bf16(rng):
    """A padded bf16 JAX fused table (ml_dtypes bfloat16) -> the port's
    unpadded table -> numpy, and (V, D) halves the same way."""
    vp, cp = 20, 96
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    jt = jnp.pad(jnp.concatenate([jnp.asarray(u, jnp.bfloat16),
                                  jnp.asarray(v, jnp.bfloat16)], axis=1),
                 ((0, vp), (0, cp)))
    t = tf.params_from_jax(np.asarray(jt), dtype=torch.bfloat16,
                           device="cpu", table_pad=(vp, cp))
    assert t.shape == (V, 2 * D) and t.dtype == torch.bfloat16
    want = np.asarray(jt[:V, :2 * D], np.float32)
    np.testing.assert_array_equal(tf.params_to_numpy(t), want)
    # back: numpy -> port table is the identity
    t2 = tf.params_from_jax(tf.params_to_numpy(t), dtype=torch.bfloat16,
                            device="cpu")
    assert torch.equal(t2, t)
    # (V, D) halves, float32
    t3 = tf.params_from_jax(u, v, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tf.params_to_numpy(t3),
                                  np.concatenate([u, v], axis=1))
