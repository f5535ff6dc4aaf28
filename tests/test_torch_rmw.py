"""The port's RMW scatter (kernel 8) and block dedup == the JAX package's
(CPU).

Kernel 8's plain version against the JAX Pallas kernel `scatter_add_rmw`
in interpret mode, at the JAX suite's own cases and tolerances
(tests/test_scatter_pallas.py:11-80); `scatter_add_dedup` against the JAX
package's (tests/test_scatter.py:25-60); the steps of both engines with
`dedup_block`, and the fused step with `rmw_scatter`, against the JAX
steps on the same SlabInputs (JAX's RMW table is padded to its 8-row
groups and trimmed through params_from_jax).  Kernel 8's per-call plan
(`sort_plan`, one stable sort) against numpy's stable argsort and the JAX
plans' sorted ids, its routes against each other, and its wrapper's
argument checks.

The JAX kernel combines duplicates per `block` of rows and adds once per
block; the port combines over the whole call and adds once.  In float32
that changes only the order of the sums.  At a bf16 table each add rounds,
so an id held by b blocks takes b + 1 roundings in JAX against 2 in the
port: the bf16 case holds each value within (nb + 1) bf16 ulps of the
largest magnitude its row reaches, nb the number of blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.kernels.scatter_pallas import scatter_add_rmw as jrmw
from word2bits_tpu.data.pipeline import cold_positions
from word2bits_tpu.models.cbow import CBOWHyper as JHyper
from word2bits_tpu.models.cbow_fused import fused_slab_step as jfused
from word2bits_tpu.models.cbow_slab import SlabInputs as JInputs
from word2bits_tpu.models.cbow_slab import slab_step as jslab
from word2bits_tpu.ops.scatter import scatter_add_dedup as jdedup
from word2bits_tpu.kernels.group_rmw import group_plan as jgroup_plan
from word2bits_tpu.kernels.span_scatter import span_plan as jspan_plan
from word2bits_tpu_torch.kernels import scatter_pallas as sp
from word2bits_tpu_torch.kernels.scatter_pallas import (
    scatter_add_rmw, scatter_add_rmw_plain, scatter_add_rmw_planned)
from word2bits_tpu_torch.kernels.span_scatter import sort_plan
from word2bits_tpu_torch.models import cbow_fused as tf
from word2bits_tpu_torch.models import cbow_slab as ts
from word2bits_tpu_torch.models.cbow import CBOWHyper
from word2bits_tpu_torch.ops.scatter import SENTINEL, scatter_add_dedup


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("V,C,N,block,slots", [
    (64, 16, 100, 32, 8),      # duplicates across and within blocks
    (64, 16, 32, 32, 32),      # one block, slots == block
    (16, 8, 7, 8, 4),          # padding slots
    (128, 32, 256, 64, 2),     # tiny pipeline depth
])
def test_rmw_plain_matches_pallas(V, C, N, block, slots):
    rng = np.random.default_rng(42)
    table = rng.normal(size=(V, C)).astype(np.float32)
    ids = rng.integers(0, V, N).astype(np.int32)
    rows = rng.normal(size=(N, C)).astype(np.float32)
    want = jrmw(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows),
                block=block, slots=slots, interpret=True)
    tt = _t(table)
    got = scatter_add_rmw(tt, _t(ids).long(), _t(rows), block=block,
                          slots=slots)
    assert got.data_ptr() == tt.data_ptr()           # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rmw_plain_heavy_duplicates():
    """Zipf-like ids: most updates hit a few rows (the training workload)."""
    rng = np.random.default_rng(0)
    V, C, N = 1000, 16, 512
    zipf = (np.minimum(rng.zipf(1.3, N), V) - 1).astype(np.int32)
    table = rng.normal(size=(V, C)).astype(np.float32)
    rows = rng.normal(size=(N, C)).astype(np.float32)
    want = jrmw(jnp.asarray(table), jnp.asarray(zipf), jnp.asarray(rows),
                block=128, slots=16, interpret=True)
    got = scatter_add_rmw(_t(table), _t(zipf).long(), _t(rows), block=128,
                          slots=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_rmw_plain_sentinel_dropped():
    """The drop sentinel (0x7FFFFFF0) and ids >= V touch no live row."""
    rng = np.random.default_rng(3)
    V, C = 32, 8
    table = rng.normal(size=(V, C)).astype(np.float32)
    ids = np.array([1, SENTINEL, 2, SENTINEL], np.int32)
    rows = rng.normal(size=(4, C)).astype(np.float32)
    want = table.copy()
    want[1] += rows[0]
    want[2] += rows[2]
    jgot = jrmw(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows),
                block=4, slots=2, interpret=True)
    np.testing.assert_allclose(np.asarray(jgot), want, rtol=1e-5, atol=1e-5)
    got = scatter_add_rmw(_t(table), _t(ids).long(), _t(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got = scatter_add_rmw(_t(table), torch.tensor([1, V, 2, V + 5]),
                          _t(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rmw_plain_bfloat16_table():
    """The JAX suite's bf16 case (float32 rows rounded to bf16 first,
    block 32 of 96 rows: nb = 3 blocks), held to (nb + 1) bf16 ulps of the
    row's largest magnitude; the port's own rounding is checked exactly
    (each id's bf16-rounded rows summed in float32, the sum rounded, one
    rounded add)."""
    rng = np.random.default_rng(9)
    V, C, N, block = 64, 16, 96, 32
    table = jnp.asarray(rng.normal(size=(V, C)), jnp.bfloat16)
    ids = rng.integers(0, V, N).astype(np.int32)
    rows = rng.normal(size=(N, C)).astype(np.float32)
    t0 = _t(np.asarray(table, np.float32)).to(torch.bfloat16)
    # (the JAX kernel donates its table)
    want = np.asarray(jrmw(table, jnp.asarray(ids),
                           jnp.asarray(rows).astype(jnp.bfloat16),
                           block=block, slots=8, interpret=True), np.float32)
    got = scatter_add_rmw(t0.clone(), _t(ids).long(), _t(rows)).float()
    nb = -(-N // block)
    scale = np.maximum(np.abs(want), np.abs(got.numpy())).max(axis=1)
    ulp = np.exp2(np.floor(np.log2(scale)) - 7)[:, None]
    assert np.all(np.abs(got.numpy() - want) <= (nb + 1) * ulp)
    # the port's numerics exactly
    r16 = torch.from_numpy(rows).to(torch.bfloat16).float()
    exact = t0.float().clone()
    for i in np.unique(ids):
        s = r16[torch.from_numpy(ids == i)].sum(dim=0)
        exact[i] = (t0[i].float() + s.to(torch.bfloat16).float()).to(
            torch.bfloat16).float()
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=0,
                               rtol=2 ** -8)


@pytest.mark.parametrize("V", [61, 64])
def test_rmw_any_vocab_and_planned(V):
    """Any V (the JAX kernel needs V % 8 == 0) and any width; the planned
    entry point (sort_plan) gives the same table as scatter_add_rmw."""
    rng = np.random.default_rng(V)
    C, N = 12, 150
    table = rng.normal(size=(V, C)).astype(np.float32)
    ids = rng.integers(0, V, N)
    ids[::17] = SENTINEL
    rows = rng.normal(size=(N, C)).astype(np.float32)
    want = table.copy()
    keep = ids < V
    np.add.at(want, ids[keep], rows[keep])
    for got in (scatter_add_rmw(_t(table), _t(ids), _t(rows)),
                scatter_add_rmw_plain(_t(table), _t(ids), _t(rows)),
                scatter_add_rmw_planned(_t(table), sort_plan(_t(ids)),
                                        _t(rows))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rmw_rejects_bad_sizes_and_devices():
    t = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="positive"):
        scatter_add_rmw(t, torch.zeros(2, dtype=torch.long),
                        torch.zeros((2, 4)), block=0)
    m = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        scatter_add_rmw_planned(m, sort_plan(
            torch.zeros(2, dtype=torch.long, device="meta")),
            torch.zeros((2, 4), device="meta"))


def _rmw_ids(rng, case: str) -> np.ndarray:
    """Zipf ids with drop sentinels and negative ids; sentinels and
    negative ids only; N = 0."""
    if case == "zipf":
        ids = np.minimum(rng.zipf(1.3, 400) - 1, 90)
        ids[rng.choice(400, 30, replace=False)] = SENTINEL
        ids[rng.choice(400, 10, replace=False)] = -2
        return ids
    if case == "dropped only":
        return rng.choice(np.array([SENTINEL, -1, -5]), 60)
    return np.zeros(0, dtype=np.int64)


@pytest.mark.parametrize("case", ["zipf", "dropped only", "N = 0"])
def test_sort_plan_is_the_stable_sort(rng, case):
    """The one sort scatter_add_rmw builds (sort_plan) gives numpy's
    stable argsort as its order and the JAX plans' sorted ids in their
    first N slots (per step and batched)."""
    ids_np = _rmw_ids(rng, case).astype(np.int32)
    ids = torch.from_numpy(ids_np)
    N = ids_np.size
    batched = torch.stack([ids, ids.flip(0)])
    steps = [(sort_plan(ids), ids)] + [(sort_plan(batched).step(s),
                                        batched[s]) for s in range(2)]
    for got, one in steps:
        one = one.numpy()
        assert got.sids.dtype == got.order.dtype == torch.int32
        np.testing.assert_array_equal(got.order.numpy(),
                                      np.argsort(one, kind="stable"))
        if N:
            for jplan in (jgroup_plan(jnp.asarray(one), 16),
                          jspan_plan(jnp.asarray(one), 128, 64, 32)):
                np.testing.assert_array_equal(got.sids.numpy(),
                                              np.asarray(jplan.sids)[:N])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmw_routes_give_one_table(rng, dtype):
    """scatter_add_rmw, scatter_add_rmw_planned(sort_plan(...)) and the
    plain version give the same table on the CPU, bit for bit (the stable
    sort keeps each id's row order), sentinels and negative ids dropped and
    other rows untouched."""
    V, C = 97, 24
    ids = torch.from_numpy(_rmw_ids(rng, "zipf"))
    rows = torch.from_numpy(rng.normal(size=(ids.numel(), C)).astype(
        np.float32))
    table = torch.from_numpy(rng.normal(size=(V, C)).astype(
        np.float32)).to(dtype)
    want = scatter_add_rmw_plain(table.clone(), ids, rows)
    for got in (scatter_add_rmw(table.clone(), ids, rows),
                scatter_add_rmw_planned(table.clone(), sort_plan(ids),
                                        rows)):
        assert torch.equal(got, want)
    keep = torch.zeros(V, dtype=torch.bool)
    keep[ids[(ids >= 0) & (ids < V)]] = True
    assert torch.equal(want[~keep], table[~keep])


def _bad_rmw_call(rng, bad):
    """(table, plan, rows) of a call kernel 8 does not take."""
    V, C = 64, 16
    ids = torch.from_numpy(_rmw_ids(rng, "zipf"))
    rows = torch.from_numpy(rng.normal(size=(ids.numel(), C)).astype(
        np.float32))
    table = torch.zeros((V, C))
    plan = sort_plan(ids)
    if bad == "sids dtype":
        plan = plan._replace(sids=plan.sids.long())
    elif bad == "sids length":
        plan = plan._replace(sids=plan.sids[:-1])
    elif bad == "order length":
        plan = plan._replace(order=plan.order[:-1])
    elif bad == "batched plan":
        plan = sort_plan(ids[None])
    elif bad == "device":
        plan = plan._replace(order=plan.order.to("meta"))
    elif bad == "table dtype":
        table = table.double()
    elif bad == "row dtype":
        rows = rows.to(torch.float16)
    elif bad == "width":
        rows = rows[:, :C - 1]
    return table, plan, rows


@pytest.mark.parametrize("bad", [
    "sids dtype", "sids length", "order length", "batched plan", "device",
    "table dtype", "row dtype", "width"])
def test_rmw_wrapper_raises_on_what_the_kernel_does_not_take(rng, bad):
    """The checks kernel 8's wrapper makes before a launch (on a CUDA
    tensor it launches the kernel or raises; it does not fall back)."""
    table, plan, rows = _bad_rmw_call(rng, bad)
    with pytest.raises(ValueError, match="scatter_add_rmw"):
        sp._check("scatter_add_rmw", table, plan, rows)


def test_rmw_check_takes_a_good_call(rng):
    table, plan, rows = _bad_rmw_call(rng, "none")
    sp._check("scatter_add_rmw", table, plan, rows)
    sp._check("scatter_add_rmw", table.to(torch.bfloat16), plan,
              rows.to(torch.bfloat16))


# ----------------------------------------------------------------- dedup
DV, DC = 257, 40


def _dedup_case(rng, n, zipf=True):
    if zipf:
        ids = np.minimum(rng.zipf(1.3, size=n) - 1, DV - 1).astype(np.int32)
    else:
        ids = rng.integers(0, DV, size=n).astype(np.int32)
    rows = rng.normal(size=(n, DC)).astype(np.float32)
    return ids, rows


@pytest.mark.parametrize("block", [32, 100, 1024])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 500])
def test_dedup_matches_jax(block, n):
    rng = np.random.default_rng(n * 7 + block)
    ids, rows = _dedup_case(rng, n)
    table = rng.normal(size=(DV, DC)).astype(np.float32)
    want = jdedup(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows),
                  block)
    got = scatter_add_dedup(_t(table), _t(ids).long(), _t(rows), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_dedup_all_same_id():
    """Every row updates one id (the JAX suite's worst case)."""
    rng = np.random.default_rng(0)
    n = 300
    ids = np.zeros(n, np.int32) + 7
    rows = rng.normal(size=(n, DC)).astype(np.float32)
    got = scatter_add_dedup(torch.zeros((DV, DC)), _t(ids).long(), _t(rows),
                            64).numpy()
    want = np.asarray(jdedup(jnp.zeros((DV, DC)), jnp.asarray(ids),
                             jnp.asarray(rows), 64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[7], rows.sum(0), rtol=1e-5, atol=1e-4)
    assert np.all(got[np.arange(DV) != 7] == 0)


def test_dedup_bf16_matches_jax():
    """bf16 table and rows: each block's float32 combine rounds once to
    bf16 and adds once; within one bf16 ulp of the larger value (the two
    combines sum in another order)."""
    rng = np.random.default_rng(1)
    ids, rows = _dedup_case(rng, 400)
    table = rng.normal(size=(DV, DC)).astype(np.float32)
    jt = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(jdedup(jt, jnp.asarray(ids),
                             jnp.asarray(rows, jnp.bfloat16), 128),
                      np.float32)
    got = scatter_add_dedup(_t(np.asarray(jt, np.float32)).to(torch.bfloat16),
                            _t(ids).long(),
                            _t(rows).to(torch.bfloat16), 128).float().numpy()
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


# ----------------------------------------------------------------- steps
V, D, B, W, K, G = 300, 16, 64, 3, 5, 8


def _slab_inputs(rng, negs_shape):
    toks = rng.integers(0, V, B + 2 * W).astype(np.int32)
    toks[rng.integers(0, B + 2 * W, 30)] = rng.integers(0, 10, 30)  # dups
    sents = np.sort(rng.integers(0, 5, B + 2 * W)).astype(np.int32)
    toks[-2:] = -1
    sents[-2:] = -1
    shrink = rng.integers(0, W, B).astype(np.int32)
    negs = rng.integers(1, V, negs_shape).astype(np.int32)
    arrays = (toks, sents, shrink, negs)
    return (JInputs(*(jnp.asarray(a) for a in arrays)),
            ts.SlabInputs(*(torch.from_numpy(a).long() for a in arrays)))


@pytest.mark.parametrize("G_,block", [(0, 64), (0, 1024), (G, 64)])
def test_slab_step_dedup_matches_jax(rng, G_, block):
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    ji, ti = _slab_inputs(rng, (B // G_, K) if G_ else (B, K))
    hk = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    ju, jv, jl = jslab(jnp.asarray(u), jnp.asarray(v), ji, jnp.float32(0.05),
                       JHyper(**hk), B, neg_sharing=G_, dedup_block=block)
    tu, tv, tl = ts.slab_step(_t(u), _t(v), ti, torch.tensor(0.05),
                              CBOWHyper(**hk), B, neg_sharing=G_,
                              dedup_block=block)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_slab_span_rejects_dedup_and_hot(rng):
    _, ti = _slab_inputs(rng, (B, K))
    args = (torch.zeros((V, D)), torch.zeros((V, D)), ti, 0.05,
            CBOWHyper(bitlevel=1, size=D, window=W, negative=K), B)
    for kw in (dict(dedup_block=64), dict(hot_rows=16)):
        with pytest.raises(ValueError, match="span"):
            ts.slab_step(*args, scatter_impl="span", **kw)


@pytest.mark.parametrize("route", ["dedup", "rmw", "dedup+hot"])
@pytest.mark.parametrize("P", [1, 2])
def test_fused_step_route_matches_jax(rng, route, P):
    """The fused step's `scat` routes against the JAX step: the block
    dedup (alone and under the hot/cold split) and the RMW scatter (JAX's
    table padded to its 8-row groups and the 128-lane tile, trimmed
    back)."""
    H = 16
    table = rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(np.float32)
    ji, ti = _slab_inputs(rng, (B // G, P * K))
    hk = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    jt, pad = jnp.asarray(table), (0, 0)
    if route == "rmw":
        pad = ((-V) % 8, (-2 * D) % 128)
        jt = jnp.pad(jt, ((0, pad[0]), (0, pad[1])))
        kw, jkw = dict(rmw_scatter=True), dict(rmw_scatter=True,
                                                col_pad=pad[1])
    else:
        kw = dict(dedup_block=32)
        jkw = dict(kw)
        if route == "dedup+hot":
            cp = cold_positions(np.asarray(ji.slab_tokens), B, W, 1, H)[0]
            kw.update(hot_rows=H, cold_pos=torch.from_numpy(cp).long())
            jkw.update(hot_rows=H, cold_pos=jnp.asarray(cp))
    want, wl = jfused(jt, ji, jnp.float32(0.05), JHyper(**hk), B, G,
                      neg_pool=P, **jkw)
    want = tf.params_from_jax(np.asarray(want), dtype=torch.float32,
                              device="cpu", table_pad=pad)
    got, tl = tf.fused_slab_step(_t(table), ti, torch.tensor(0.05),
                                 CBOWHyper(**hk), B, G, neg_pool=P, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(tl), float(wl), rtol=1e-5)


def test_fused_chunk_compose_rules():
    """The JAX chunk's compose rules: rmw excludes the score kernel and the
    restructuring routes; span/grmw exclude them all."""
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    mk = tf.make_fused_train_chunk
    with pytest.raises(ValueError, match="rmw_scatter"):
        mk(hyper, V, B, 2, G, rmw_scatter=True, use_pallas=True)
    with pytest.raises(ValueError, match="rmw_scatter"):
        mk(hyper, V, B, 2, G, rmw_scatter=True, hot_rows=16)
    with pytest.raises(ValueError, match="replaces"):
        mk(hyper, V, B, 2, G, scatter_impl="span", dedup_block=32)
    with pytest.raises(ValueError, match="replaces"):
        mk(hyper, V, B, 2, G, scatter_impl="grmw", rmw_scatter=True)
    with pytest.raises(ValueError, match="hot_rows"):
        mk(hyper, V, B, 2, G, strat_lanes=(2, 1.0, 1.0))
