"""The port's hot/cold split == the JAX package's (CPU).

Kernel 6's plain version against the JAX Pallas kernel
`hot_slice_add_pallas` in interpret mode; its plan (`hot_plan`: the sorted
keys the kernel reads, their source rows, the run starts) and its
wrapper's argument checks; `hot_slice_add`, the cold map
(`cold_positions`) and the stratified sampler's tables against the JAX
package's; the fused step with `hot_rows` (with a cold map, with and
without `hot_pallas`, with `use_pallas`), with stratified lanes and with
the dense hot stratum (with and without a cold map) against the JAX step
on the same SlabInputs; and a chunk with `-hot-rows` against the same
chunk without it on injected draws.

Tolerances: float32 tables atol 1e-5 and losses rtol 1e-5, as
tests/test_kernels.py:92-93 and :121-125.  A bf16 head is held to one bf16
ulp of each value: both versions sum bf16-rounded rows in float32 in
another order and round once (twice with `extra`) into bf16, so a sum that
lands near a rounding midpoint may round to the neighbouring bf16 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.data.pipeline import cold_positions as jcold
from word2bits_tpu.kernels.hot_pallas import hot_slice_add_pallas as jhotk
from word2bits_tpu.models.cbow import CBOWHyper as JHyper
from word2bits_tpu.models.cbow_fused import fused_slab_step as jfused
from word2bits_tpu.models.cbow_slab import SlabInputs as JInputs
from word2bits_tpu.models.cbow_slab import slab_step as jslab
from word2bits_tpu.ops.scatter import hot_slice_add as jhot
from word2bits_tpu.sampling.unigram import \
    build_stratified_tables as jstrat
from word2bits_tpu_torch.data.pipeline import cold_positions
from word2bits_tpu_torch.kernels import hot_pallas as hk
from word2bits_tpu_torch.kernels.hot_pallas import (hot_plan,
                                                    hot_slice_add_pallas,
                                                    hot_slice_add_plain)
from word2bits_tpu_torch.models import cbow_fused as tf
from word2bits_tpu_torch.models import cbow_slab as ts
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.ops.scatter import SENTINEL, hot_slice_add
from word2bits_tpu_torch.sampling.unigram import (
    build_alias_table, build_stratified_tables, draw_cold,
    draw_negatives_stratified)

V, D, B, W, K, G = 300, 16, 64, 3, 5, 8
HV, HC, HN, HH = 300, 40, 777, 128      # kernel 6 shapes (test_kernels.py)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _assert_bf16_close(got: np.ndarray, want: np.ndarray) -> None:
    """Within one bf16 ulp of the larger of the two values."""
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp), \
        float(np.max(np.abs(got - want) / ulp))


def _hot_case(rng, extra: bool):
    table = rng.uniform(-1, 1, (HV, HC)).astype(np.float32)
    # heavy duplicates on the head, ids < 0 and >= H too
    ids = np.concatenate([np.minimum(rng.zipf(1.3, HN - 100) - 1, HV - 1),
                          rng.integers(-5, HV, 100)]).astype(np.int32)
    rng.shuffle(ids)
    rows = rng.uniform(-1, 1, (HN, HC)).astype(np.float32)
    ext = rng.uniform(-1, 1, (HH, HC)).astype(np.float32) if extra else None
    return table, ids, rows, ext


def _to_torch(table, dtype):
    return torch.from_numpy(table.copy()).to(dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [False, True])
def test_hot_kernel_plain_matches_pallas(rng, dtype, extra):
    """Kernel 6's plain version == hot_slice_add_pallas(interpret=True),
    ids < 0 and >= H skipped, extra rounded into the head first."""
    table, ids, rows, ext = _hot_case(rng, extra)
    jt = jnp.asarray(table, dtype)
    want = np.asarray(jhotk(jt, jnp.asarray(ids), jnp.asarray(rows), HH,
                            extra=None if ext is None else jnp.asarray(ext),
                            interpret=True), np.float32)
    tt = _to_torch(table, getattr(torch, dtype))
    got = hot_slice_add_pallas(
        tt, torch.from_numpy(ids).long(), torch.from_numpy(rows), HH,
        extra=None if ext is None else torch.from_numpy(ext))
    assert got.data_ptr() == tt.data_ptr()           # in place
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=1e-5)
    else:
        _assert_bf16_close(_np(got), want)
    # rows past the head are untouched
    np.testing.assert_array_equal(
        _np(got)[HH:], np.asarray(jt, np.float32)[HH:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extra", [False, True])
def test_hot_slice_add_matches_jax(rng, dtype, extra):
    """ops/scatter.hot_slice_add == the JAX package's (extra added in
    float32, one rounding)."""
    table, ids, rows, ext = _hot_case(rng, extra)
    want = np.asarray(jhot(jnp.asarray(table, dtype), jnp.asarray(ids),
                           jnp.asarray(rows), HH,
                           extra=None if ext is None else jnp.asarray(ext)),
                      np.float32)
    got = hot_slice_add(_to_torch(table, getattr(torch, dtype)),
                        torch.from_numpy(ids).long(), torch.from_numpy(rows),
                        HH, extra=None if ext is None
                        else torch.from_numpy(ext))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=1e-5)
    else:
        _assert_bf16_close(_np(got), want)


def test_hot_plan_runs(rng):
    """The kernel's plan: each head row's run holds exactly its rows, in
    their original order; ids outside [0, H) sort last."""
    _, ids, _, _ = _hot_case(rng, False)
    plan = hot_plan(torch.from_numpy(ids).long(), HH)
    order, starts = plan.order.long().numpy(), plan.starts.long().numpy()
    assert starts[0] == 0 and starts[-1] == ((ids >= 0) & (ids < HH)).sum()
    for h in (0, 1, 5, HH - 1):
        run = order[starts[h]:starts[h + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(ids == h))
    # batched over steps (the chunk's hoisted plan): each step's plan
    two = torch.from_numpy(np.stack([ids, ids[::-1].copy()])).long()
    batched = hot_plan(two, HH)
    for s in range(2):
        for a, b in zip(batched.step(s), hot_plan(two[s], HH)):
            assert torch.equal(a, b)


def _plan_ids(rng, case: str) -> np.ndarray:
    """Ids for the plan cases: the Zipf head with cold and negative ids,
    cold and negative ids only, one head id, and N = 0."""
    if case == "zipf":
        return _hot_case(rng, False)[1]
    if case == "cold and negative":
        return rng.choice(np.array([-3, -1, HH, HH + 7, SENTINEL]),
                          200).astype(np.int32)
    if case == "one head id":
        ids = np.full(300, 5, dtype=np.int32)
        ids[::7] = -1
        return ids
    return np.zeros(0, dtype=np.int32)


@pytest.mark.parametrize("case", ["zipf", "cold and negative",
                                  "one head id", "N = 0"])
def test_hot_plan_sids(rng, case):
    """HotPlan.sids is the stable sort of the ids keyed H outside [0, H)
    (cold and negative ids last), `order` its source rows, `starts` the
    run starts within it; the batched plan (the chunk's hoisted one)
    equals the per-step plans."""
    ids = _plan_ids(rng, case)
    plan = hot_plan(torch.from_numpy(ids).long(), HH)
    key = np.where((ids >= 0) & (ids < HH), ids, HH)
    order = np.argsort(key, kind="stable")
    assert plan.sids.dtype == plan.order.dtype == torch.int32
    np.testing.assert_array_equal(plan.sids.numpy(), key[order])
    np.testing.assert_array_equal(plan.order.numpy(), order)
    np.testing.assert_array_equal(
        plan.starts.numpy(), np.searchsorted(key[order], np.arange(HH + 1)))
    two = torch.from_numpy(np.stack([ids, ids[::-1].copy()])).long()
    batched = hot_plan(two, HH)
    for s in range(2):
        for a, b in zip(batched.step(s), hot_plan(two[s], HH)):
            assert torch.equal(a, b)


def _bad_hot_call(rng, bad):
    """(table, ids, rows, extra, plan) of a call the kernel does not
    take."""
    table, ids, rows, ext = _hot_case(rng, True)
    table, rows = torch.from_numpy(table), torch.from_numpy(rows)
    ids, extra = torch.from_numpy(ids).long(), torch.from_numpy(ext)
    plan = hot_plan(ids, HH)
    if bad == "sids dtype":
        plan = plan._replace(sids=plan.sids.long())
    elif bad == "sids length":
        plan = plan._replace(sids=plan.sids[:-1])
    elif bad == "starts length":
        plan = plan._replace(starts=plan.starts[:-1])
    elif bad == "batched plan":
        plan = hot_plan(ids[None], HH)
    elif bad == "device":
        plan = plan._replace(sids=plan.sids.to("meta"))
    elif bad == "table dtype":
        table = table.double()
    elif bad == "extra shape":
        extra = extra[:-1]
    elif bad == "hot_rows":
        return table, ids, rows, None, hot_plan(ids, HV + 1)
    return table, ids, rows, extra, plan


@pytest.mark.parametrize("bad", [
    "sids dtype", "sids length", "starts length", "batched plan", "device",
    "table dtype", "extra shape", "hot_rows"])
def test_hot_wrapper_raises_on_what_the_kernel_does_not_take(rng, bad):
    """The checks kernel 6's wrapper makes before a launch (on a CUDA
    tensor it launches the kernel or raises; it does not fall back)."""
    table, ids, rows, extra, plan = _bad_hot_call(rng, bad)
    H = HV + 1 if bad == "hot_rows" else HH
    with pytest.raises(ValueError):
        hk._check("hot_slice_add_pallas", table, ids, rows, H, extra, plan)


def test_hot_check_takes_a_good_call(rng):
    table, ids, rows, extra, plan = _bad_hot_call(rng, "none")
    hk._check("hot_slice_add_pallas", table, ids, rows, HH, extra, plan)
    hk._check("hot_slice_add_pallas", table.to(torch.bfloat16), ids,
              rows.to(torch.bfloat16), HH, None, plan)


def test_hot_wrappers_raise_off_cpu_and_cuda():
    t = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        hot_slice_add_pallas(t, torch.zeros(2, dtype=torch.long,
                                            device="meta"),
                             torch.zeros((2, 4), device="meta"), 2)


@pytest.mark.parametrize("Bc,Wc,n_rows,H,min_width", [
    (64, 3, 5, 30, 0),
    (64, 3, 9, 30, 600),      # min_width above the span
    (16, 2, 40, 8, 0),        # rows past the tokens (right margin)
    (128, 8, 3, 1, 0),
])
def test_cold_positions_bit_equal(rng, Bc, Wc, n_rows, H, min_width):
    tokens = rng.integers(0, 60, 5 * Bc + 2 * Wc).astype(np.int32)
    tokens[:Wc] = -1
    tokens[-7:] = -1
    want = jcold(tokens, Bc, Wc, n_rows, H, min_width=min_width)
    got = cold_positions(tokens, Bc, Wc, n_rows, H, min_width=min_width)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Vs,H,K_", [(500, 40, 5), (500, 2, 24),
                                     (64, 64, 6), (2000, 300, 24)])
def test_stratified_tables_bit_equal(Vs, H, K_):
    """The strata's alias arrays, p_hot, hot_probs, lane_split and
    dense_split, bit for bit (weights are a Zipf count^0.75 with `</s>`)."""
    w = (np.arange(1, Vs + 1, dtype=np.float64) ** -1.05 * 1e6) ** 0.75
    j, t = jstrat(w, H), build_stratified_tables(w, H)
    assert (t.p_hot, t.hot_rows) == (j.p_hot, j.hot_rows)
    np.testing.assert_array_equal(t.hot_probs, j.hot_probs)
    for jt, tt in ((j.hot, t.hot), (j.cold, t.cold)):
        np.testing.assert_array_equal(tt.prob.numpy(), np.asarray(jt.prob))
        np.testing.assert_array_equal(tt.alias.numpy(),
                                      np.asarray(jt.alias))
    assert t.lane_split(K_) == j.lane_split(K_)
    if H < Vs:
        (tk, tw, th), (jk, jw, jh) = t.dense_split(K_), j.dense_split(K_)
        assert (tk, tw) == (jk, jw) and th.dtype == jh.dtype == np.float32
        np.testing.assert_array_equal(th, jh)
    else:
        with pytest.raises(ValueError, match="cold stratum"):
            t.dense_split(K_)


def test_stratified_draws_respect_strata():
    """Hot lanes draw ids in [1, H) (id 0 has no mass), cold lanes and the
    dense-hot draws ids in [H, V); both from the generator alone."""
    Vs, H, K_, P = 400, 20, 6, 2
    st = build_stratified_tables(np.arange(Vs, 0, -1.0) ** 0.75, H)
    kh = st.lane_split(K_)[0]
    gen = torch.Generator().manual_seed(0)
    negs = draw_negatives_stratified(gen, st.hot, st.cold, (3, 7), P, K_, kh,
                                     H)
    assert negs.shape == (3, 7, P * K_)
    lanes = negs.reshape(3, 7, P, K_)
    assert (lanes[..., :kh] >= 1).all() and (lanes[..., :kh] < H).all()
    assert (lanes[..., kh:] >= H).all() and (lanes[..., kh:] < Vs).all()
    again = draw_negatives_stratified(torch.Generator().manual_seed(0),
                                      st.hot, st.cold, (3, 7), P, K_, kh, H)
    assert torch.equal(negs, again)
    cold = draw_cold(gen, st.cold, (5, 9), H)
    assert (cold >= H).all() and (cold < Vs).all()


# ------------------------------------------------------------ the steps
def _step_case(rng, H):
    table = rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(np.float32)
    toks = rng.integers(-1, V, B + 2 * W).astype(np.int32)
    toks[rng.integers(0, B + 2 * W, 20)] = rng.integers(0, H, 20)  # hot ones
    sents = np.sort(rng.integers(-1, 5, B + 2 * W)).astype(np.int32)
    shrink = rng.integers(0, W, B).astype(np.int32)
    return table, toks, sents, shrink


def _negs(rng, kind, P, H, kh=0, kc=0):
    if kind == "strat":
        hot = rng.integers(1, H, (B // G, P, kh))
        cold = rng.integers(H, V, (B // G, P, K - kh))
        return np.concatenate([hot, cold], axis=2).reshape(
            B // G, P * K).astype(np.int32)
    if kind == "dense":
        return rng.integers(H, V, (B // G, P * kc)).astype(np.int32)
    return rng.integers(1, V, (B // G, P * K)).astype(np.int32)


STEP_CASES = {
    # name: (negatives, hot_pallas, use_pallas, cold map)
    "hot": ("plain", False, False, True),
    "hot+hot_pallas": ("plain", True, False, True),
    "hot+use_pallas": ("plain", True, True, True),
    "strat": ("strat", True, False, True),
    "dense": ("dense", True, False, True),
    "dense, no cold map": ("dense", False, False, False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fused_step_hot_matches_jax(rng, case):
    kind, hot_pallas, use_pallas, with_map = STEP_CASES[case]
    H, P = 32, 2
    table, toks, sents, shrink = _step_case(rng, H)
    wts = rng.uniform(0.5, 1.0, V) / np.arange(1, V + 1)
    st = jstrat(wts, H)
    kh, w_hot, w_cold = st.lane_split(K)
    kc, wc, hot_w = st.dense_split(K)
    negs = _negs(rng, kind, P, H, kh=kh, kc=kc)
    reg = 0.0 if use_pallas else 0.01
    hk = dict(bitlevel=1, size=D, window=W, negative=K, reg=reg)
    kw = dict(hot_rows=H, hot_pallas=hot_pallas, use_pallas=use_pallas)
    if kind == "strat":
        kw["strat_lanes"] = (kh, w_hot, w_cold)
    cp = jcold(toks, B, W, 1, H)[0] if with_map else None

    jkw = dict(kw, cold_pos=None if cp is None else jnp.asarray(cp))
    if kind == "dense":
        jkw["dense_hot"] = (wc, hot_w)
    ji = JInputs(slab_tokens=jnp.asarray(toks), slab_sents=jnp.asarray(sents),
                 shrink=jnp.asarray(shrink), neg_ids=jnp.asarray(negs))
    want, wloss = jfused(jnp.asarray(table), ji, jnp.float32(0.05),
                         JHyper(**hk), B, G, neg_pool=P, **jkw)

    tkw = dict(kw, cold_pos=None if cp is None else torch.from_numpy(cp)
               .long())
    if kind == "dense":
        tkw["dense_hot"] = (wc, torch.from_numpy(hot_w))
    ti = ts.SlabInputs(*(torch.from_numpy(a).long()
                         for a in (toks, sents, shrink, negs)))
    hot_slice_add_pallas.launches = 0
    got, loss = tf.fused_slab_step(torch.from_numpy(table.copy()), ti,
                                   torch.tensor(0.05), CBOWHyper(**hk), B, G,
                                   neg_pool=P, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)
    assert hot_slice_add_pallas.launches == 0        # the CPU: plain only


def test_fused_step_hot_rejects_unsplit_strat(rng):
    table, toks, sents, shrink = _step_case(rng, 32)
    ti = ts.SlabInputs(*(torch.from_numpy(a).long() for a in (
        toks, sents, shrink, _negs(rng, "strat", 1, 32, kh=2))))
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    with pytest.raises(ValueError, match="cold_pos"):
        tf.fused_slab_step(torch.from_numpy(table), ti, 0.05, hyper, B, G,
                           hot_rows=32, strat_lanes=(2, 1.0, 1.0))
    with pytest.raises(ValueError, match="hot_rows"):
        tf.fused_slab_step(torch.from_numpy(table), ti, 0.05, hyper, B, G,
                           dense_hot=(1.0, torch.ones(32)))


@pytest.mark.parametrize("hot_pallas", [False, True])
def test_chunk_hot_rows_equals_plain_chunk(rng, hot_pallas):
    """The port's form of the JAX package's test_hot_rows_same_trajectory:
    on injected draws, a 3-step chunk with -hot-rows (its cold map built
    from the epoch tokens, the chunk starting at the map's second row)
    gives the plain chunk's table and loss."""
    S, P, H = 3, 2, 24
    n = (S + 1) * B + 2 * W + 40
    tokens = rng.integers(0, V, n).astype(np.int64)
    tokens[rng.integers(0, n, n // 2)] = rng.integers(0, H, n // 2)
    tokens[:W] = -1
    sents = (np.arange(n) // 37).astype(np.int64)
    sents[:W] = -1
    shrinks = torch.from_numpy(rng.integers(0, W, (S, B)))
    negs = torch.from_numpy(rng.integers(1, V, (S, B // G, P * K)))
    table = rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(np.float32)
    sc = ChunkScalars(base0=W + B, alpha0=0.05, wca_start=1000.0,
                      wca_per_step=float(B), denom=3e4)
    cold = torch.from_numpy(cold_positions(tokens, B, W, n // B, H)).long()
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    atab = build_alias_table(np.ones(V))
    outs = []
    for kw, extra in ((dict(), {}), (dict(hot_rows=H, hot_pallas=hot_pallas),
                                     dict(cold_pos=cold))):
        chunk = tf.make_fused_train_chunk(hyper, V, B, S, neg_sharing=G,
                                          neg_pool=P, banded=8, **kw)
        outs.append(chunk(torch.from_numpy(table.copy()),
                          torch.from_numpy(tokens), torch.from_numpy(sents),
                          atab, sc, shrinks=shrinks, negs=negs, **extra))
    (t0, l0), (t1, l1) = outs
    np.testing.assert_allclose(t1.numpy(), t0.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    assert not np.array_equal(t1.numpy(), table)


@pytest.mark.parametrize("kind", ["strat", "dense"])
def test_chunk_draws_strata_from_generator(rng, kind):
    """Without injected draws the stratified and dense-hot chunks draw
    from their generator and their alias tables (the (hot, cold) pair, or
    the cold stratum): same seed, same table; the cold map is optional."""
    S, P, H = 2, 2, 24
    n = S * B + 2 * W
    tokens = torch.from_numpy(rng.integers(0, V, n)).long()
    sents = torch.zeros(n, dtype=torch.long)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, 2 * D))
                             .astype(np.float32))
    st = build_stratified_tables(np.arange(V, 0, -1.0) ** 0.75, H)
    if kind == "strat":
        kw, atab = dict(strat_lanes=st.lane_split(K)), (st.hot, st.cold)
        extra = dict(cold_pos=torch.from_numpy(cold_positions(
            tokens.numpy(), B, W, S, H)).long())
    else:
        kw, atab, extra = dict(dense_hot=st.dense_split(K)), st.cold, {}
    chunk = tf.make_fused_train_chunk(CBOWHyper(bitlevel=1, size=D, window=W,
                                                negative=K),
                                      V, B, S, neg_sharing=G, neg_pool=P,
                                      banded=8, hot_rows=H, **kw)
    sc = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                      wca_per_step=float(B), denom=1e5)
    outs = [chunk(table.clone(), tokens, sents, atab, sc,
                  torch.Generator().manual_seed(seed), **extra)
            for seed in (3, 3, 4)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][0], outs[2][0])
    assert np.isfinite(float(outs[0][1]))


@pytest.mark.parametrize("G_", [0, G])
def test_slab_step_hot_rows_matches_jax(rng, G_):
    """The slab engine's scatter_add_hot (models API only) == the JAX
    step's, per-center and shared negatives, float32 tables (at a bf16
    table the cold rows' one-by-one bf16 adds of duplicates round in
    another order in the two scatters)."""
    H = 32
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    _, toks, sents, shrink = _step_case(rng, H)
    toks = np.maximum(toks, 0)
    negs = rng.integers(1, V, (B // G_, K) if G_ else (B, K)).astype(
        np.int32)
    hk = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    ji = JInputs(slab_tokens=jnp.asarray(toks), slab_sents=jnp.asarray(sents),
                 shrink=jnp.asarray(shrink), neg_ids=jnp.asarray(negs))
    ju, jv, jl = jslab(jnp.asarray(u), jnp.asarray(v), ji, jnp.float32(0.05),
                       JHyper(**hk), B, neg_sharing=G_, hot_rows=H)
    ti = ts.SlabInputs(*(torch.from_numpy(a).long()
                         for a in (toks, sents, shrink, negs)))
    tu, tv, tl = ts.slab_step(torch.from_numpy(u), torch.from_numpy(v), ti,
                              torch.tensor(0.05), CBOWHyper(**hk), B,
                              neg_sharing=G_, hot_rows=H)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_hot_plain_follows_pallas_not_xla(rng):
    """With `extra`, kernel 6's plain version rounds head + extra before
    the rows' sum (the Pallas function) and hot_slice_add once (its XLA
    twin): at a bf16 table the two differ somewhere."""
    table, ids, rows, ext = _hot_case(rng, True)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(rows), HH)
    a = hot_slice_add_plain(_to_torch(table, torch.bfloat16), *args,
                            extra=torch.from_numpy(ext))
    b = hot_slice_add(_to_torch(table, torch.bfloat16), *args,
                      extra=torch.from_numpy(ext))
    assert not torch.equal(a, b)
