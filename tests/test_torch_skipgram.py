"""The port's skip-gram step and chunk == the JAX package's (CPU).

Same numpy inputs (SlabInputs: slab tokens, sentence ids, window shrinks,
negatives) through both packages, on float32 tables carried over with
`cbow_slab.params_from_jax`.  Tolerances start from the JAX suite's own
(tests/test_skipgram.py: tables atol 1e-5, loss rtol 1e-4; the dense-hot
oracle atol 2e-5); a three-step chunk on injected draws is held against
three JAX steps at atol 1e-4 (as tests/test_torch_slab.py's chunks).  On
bf16 tables a row with n adds is held within n + 1 bf16 ulps of the JAX
table's (the rows are rounded to bf16 before each add in both packages;
the float32 rows and the order of equal-id adds may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.config import Word2BitsConfig as JConfig
from word2bits_tpu.models.cbow import CBOWHyper as JHyper
from word2bits_tpu.models.cbow_slab import SlabInputs as JInputs
from word2bits_tpu.models.skipgram import skipgram_slab_step as jstep
from word2bits_tpu_torch.config import Word2BitsConfig as TConfig
from word2bits_tpu_torch.models import cbow as tcbow
from word2bits_tpu_torch.models import cbow_slab as ts
from word2bits_tpu_torch.models import skipgram as tsg
from word2bits_tpu_torch.sampling.unigram import build_alias_table

V, D, B, W, K, H = 120, 16, 32, 3, 5, 12


def _case(rng, G, P, dense=False, kc=K):
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    toks = rng.integers(1, V, B + 2 * W).astype(np.int32)
    toks[:4] = rng.integers(1, H, 4)              # some hot centers
    sents = np.sort(rng.integers(0, 4, B + 2 * W)).astype(np.int32)
    toks[-2:] = -1
    sents[-2:] = -1
    shrink = rng.integers(0, W, B).astype(np.int32)
    shape = (B // G, P * kc) if G else (B, kc)
    lo = H if dense else 1
    negs = rng.integers(lo, V, shape).astype(np.int32)
    if not dense:
        negs.reshape(-1)[:3] = np.maximum(toks[W:W + 3], 1)  # skipped
    return u, v, (toks, sents, shrink, negs)


def _dense(rng):
    hot_w = (0.05 + rng.uniform(0, 0.3, H)).astype(np.float32)
    hot_w[0] = 0.0
    return 1.21, hot_w


def _jax_step(u, v, inputs, alpha, hk, G, P, dedup, dense):
    ji = JInputs(*(jnp.asarray(a) for a in inputs))
    ou, ov, loss = jstep(jnp.asarray(u), jnp.asarray(v), ji,
                         jnp.float32(alpha), JHyper(**hk), B, G,
                         dedup_block=dedup, neg_pool=P, dense_hot=dense)
    return np.asarray(ou), np.asarray(ov), float(loss)


def _torch_step(u, v, inputs, alpha, hk, G, P, dedup, dense):
    ti = ts.SlabInputs(*(torch.from_numpy(a).long() for a in inputs))
    tu, tv, loss = tsg.skipgram_slab_step(
        torch.from_numpy(u.copy()), torch.from_numpy(v.copy()), ti,
        torch.tensor(alpha), tcbow.CBOWHyper(**hk), B, G,
        dedup_block=dedup, neg_pool=P, dense_hot=dense)
    return tu.numpy(), tv.numpy(), float(loss)


# (bitlevel, reg, G, P, dense-hot, dedup_block)
CASES = [
    (1, 0.0, 0, 1, False, 0),
    (0, 0.01, 0, 1, False, 0),
    (2, 0.005, 0, 1, False, 0),
    (8, 0.0, 0, 1, False, 0),
    (1, 0.0, 8, 1, False, 0),
    (1, 0.005, 8, 2, False, 0),
    (2, 0.0, 4, 2, False, 0),
    (8, 0.01, 8, 4, False, 0),
    (1, 0.01, 0, 1, True, 0),
    (0, 0.0, 8, 2, True, 0),
    (1, 0.0, 0, 1, False, 16),
    (0, 0.005, 8, 1, False, 32),
]


@pytest.mark.parametrize("bitlevel,reg,G,P,dense,dedup", CASES)
def test_skipgram_step_matches_jax(rng, bitlevel, reg, G, P, dense, dedup):
    kc = 2 if dense else K
    u, v, inputs = _case(rng, G, P, dense, kc)
    dh = _dense(rng) if dense else None
    hk = dict(bitlevel=bitlevel, size=D, window=W, negative=kc, reg=reg)
    wu, wv, wl = _jax_step(u, v, inputs, 0.05, hk, G, P, dedup, dh)
    tu, tv, tl = _torch_step(u, v, inputs, 0.05, hk, G, P, dedup, dh)
    atol = 2e-5 if dense else 1e-5
    np.testing.assert_allclose(tu, wu, atol=atol)
    np.testing.assert_allclose(tv, wv, atol=atol)
    np.testing.assert_allclose(tl, wl, rtol=1e-4, atol=1e-4)


def test_params_from_jax_carry_skipgram_tables(rng):
    """The JAX step's tables come back through params_from_jax unchanged
    (unpadded split tables: nothing to trim) and a second port step from
    them equals a second JAX step."""
    u, v, inputs = _case(rng, 0, 1)
    hk = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.0)
    wu, wv, _ = _jax_step(u, v, inputs, 0.05, hk, 0, 1, 0, None)
    pu, pv = ts.params_from_jax(wu, wv, dtype=torch.float32, device="cpu")
    assert torch.equal(pu, torch.from_numpy(wu.copy()))
    wu2, wv2, _ = _jax_step(wu, wv, inputs, 0.04, hk, 0, 1, 0, None)
    tu2, tv2, _ = _torch_step(pu.numpy(), pv.numpy(), inputs, 0.04, hk, 0, 1,
                              0, None)
    np.testing.assert_allclose(tu2, wu2, atol=1e-5)
    np.testing.assert_allclose(tv2, wv2, atol=1e-5)


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("G,P,dense", [(0, 1, False), (8, 2, False),
                                       (0, 1, True)])
def test_skipgram_step_bf16_within_stated_ulps(rng, G, P, dense):
    """bf16 tables: each row rounds once per add of an update row, so a
    row with n adds (duplicate ids; the dense-hot head one more) may
    differ from the JAX package's by n + 1 bf16 ulps of its value."""
    import ml_dtypes
    kc = 2 if dense else K
    u, v, inputs = _case(rng, G, P, dense, kc)
    dh = _dense(rng) if dense else None
    hk = dict(bitlevel=1, size=D, window=W, negative=kc, reg=0.0)
    ji = JInputs(*(jnp.asarray(a) for a in inputs))
    ju, jv, jl = jstep(jnp.asarray(u, jnp.bfloat16),
                       jnp.asarray(v, jnp.bfloat16), ji, jnp.float32(0.05),
                       JHyper(**hk), B, G, neg_pool=P, dense_hot=dh)
    pu, pv = ts.params_from_jax(np.asarray(jnp.asarray(u, jnp.bfloat16)),
                                np.asarray(jnp.asarray(v, jnp.bfloat16)),
                                dtype=torch.bfloat16, device="cpu")
    ti = ts.SlabInputs(*(torch.from_numpy(a).long() for a in inputs))
    tu, tv, tl = tsg.skipgram_slab_step(pu, pv, ti, torch.tensor(0.05),
                                        tcbow.CBOWHyper(**hk), B, G,
                                        neg_pool=P, dense_hot=dh)
    toks, _, _, negs = inputs
    slab = np.maximum(toks, 0)
    adds_u = np.bincount(slab, minlength=V)
    adds_v = np.bincount(np.concatenate([slab[W:W + B], negs.reshape(-1)]),
                         minlength=V)
    if dense:
        adds_v[:H] += 1
    for got, want, adds in ((tu, ju, adds_u), (tv, jv, adds_v)):
        g = got.to(torch.float32).numpy()
        w = np.asarray(want).astype(ml_dtypes.bfloat16).astype(np.float32)
        tol = (adds[:, None] + 1) * _ulp_bf16(w)
        assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w) / tol)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-4)


def _jax_alpha(sc, s):
    wca = jnp.float32(sc.wca_start) + jnp.float32(s) * jnp.float32(
        sc.wca_per_step)
    alpha = jnp.float32(sc.alpha0) * (1.0 - wca / jnp.float32(sc.denom))
    return jnp.maximum(alpha, jnp.float32(sc.alpha0) * 1e-4)


@pytest.mark.parametrize("G,P,dense", [(0, 1, False), (8, 2, False),
                                       (0, 1, True)])
def test_skipgram_chunk_matches_sequential_jax_steps(rng, G, P, dense):
    """Three steps of the port's chunk on injected draws == three JAX
    skipgram_slab_step calls at the same float32 LR schedule."""
    S, kc = 3, (2 if dense else K)
    n = S * B + 2 * W + 40
    tokens = rng.integers(0, V, n).astype(np.int32)
    tokens[:W] = -1
    sents = (np.arange(n) // 23).astype(np.int32)
    sents[:W] = -1
    shrinks = rng.integers(0, W, (S, B)).astype(np.int64)
    rows = B // G if G else B
    negs = rng.integers(H if dense else 1, V, (S, rows, P * kc))
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    sc = tcbow.ChunkScalars(base0=W, alpha0=0.05, wca_start=1000.0,
                            wca_per_step=float(B) * 1.3, denom=3e4)
    dh = _dense(rng) if dense else None
    hk = dict(bitlevel=1, size=D, window=W, negative=kc, reg=0.0)
    wu, wv, wloss = u, v, 0.0
    for s in range(S):
        lo = sc.base0 + s * B - W
        inputs = (tokens[lo:lo + B + 2 * W], sents[lo:lo + B + 2 * W],
                  shrinks[s].astype(np.int32), negs[s].astype(np.int32))
        ji = JInputs(*(jnp.asarray(a) for a in inputs))
        ou, ov, l = jstep(jnp.asarray(wu), jnp.asarray(wv), ji,
                          _jax_alpha(sc, s), JHyper(**hk), B, G, neg_pool=P,
                          dense_hot=dh)
        wu, wv, wloss = np.asarray(ou), np.asarray(ov), wloss + float(l)
    chunk = tsg.make_skipgram_train_chunk(
        tcbow.CBOWHyper(**hk), V, B, S, neg_sharing=G, neg_pool=P,
        hot_rows=H if dense else 0,
        dense_hot=(kc,) + dh if dense else None)
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


def test_skipgram_chunk_draws_from_its_generator(rng):
    """Without injected draws the chunk draws from `gen`: the same seed
    gives the same tables, another seed others; dense-hot draws are cold
    ids offset by H."""
    S = 2
    n = S * B + 2 * W + 8
    tokens = torch.from_numpy(rng.integers(1, V, n)).long()
    sents = torch.zeros(n, dtype=torch.long)
    u = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32))
    sc = tcbow.ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                            wca_per_step=float(B), denom=1e6)
    hyper = tcbow.CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    chunk = tsg.make_skipgram_train_chunk(hyper, V, B, S)
    outs = [chunk(u.clone(), v.clone(), tokens, sents,
                  build_alias_table(np.ones(V)), sc,
                  torch.Generator().manual_seed(seed))[1]
            for seed in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    from word2bits_tpu_torch.sampling.unigram import draw_cold
    cold = build_alias_table(np.ones(V - H))
    d = draw_cold(torch.Generator().manual_seed(1), cold, (4, 6), H)
    assert int(d.min()) >= H and int(d.max()) < V


BAD_SKIPGRAM = [
    dict(hot_rows=8),                                   # needs dense-hot
    dict(use_pallas=True, neg_sharing=8),
    dict(banded_tile=8),
    dict(scatter_impl="span"),
    dict(rmw_scatter=True, neg_sharing=8, fused_tables=True),
    dict(neg_stratify=True, hot_rows=8, neg_sharing=8, fused_tables=True),
]


@pytest.mark.parametrize("kw", BAD_SKIPGRAM)
def test_skipgram_config_errors_match_jax(kw):
    """Each configuration the JAX package refuses with skip-gram is refused
    by the port with the same message."""
    base = dict(model="skipgram", batch_size=32)
    with pytest.raises(ValueError) as je:
        JConfig(**base, **kw)
    with pytest.raises(ValueError) as te:
        TConfig(**base, **kw)
    assert str(te.value) == str(je.value)


def test_skipgram_dense_hot_config_accepted():
    for pkg in (JConfig, TConfig):
        cfg = pkg(model="skipgram", hot_rows=8, neg_dense_hot=True)
        assert cfg.model == "skipgram" and cfg.device_epoch_on
