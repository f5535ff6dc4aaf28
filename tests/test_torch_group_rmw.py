"""The port's group-RMW scatter (kernels/group_rmw.py) == the JAX package's
scatter_add_grmw (interpret mode, CPU).

On CPU tensors the port's wrappers run the plain version (the CUDA kernel
runs only on the card, where chip_smoke.py's [grmw] and [grmw edges]
phases hold it against that plain version at the 3.7M x 800d shapes and at
its tiles' edges).  The cases are those of tests/test_group_rmw.py, always
with chunk >= slots: the JAX kernel reads past its block when chunk <
slots, and the port raises there; and the shapes the tiled kernel's design
makes risky: one id holding 80% of the rows or all of them (its run cut
over many tiles), beside drop sentinels and negative ids, and a width that
is not a multiple of 4.  The checks the wrapper makes before a launch
(`_check`) are tested too.

Tolerances.  float32 tables: both sum each id's rows in float32 in another
order, so an entry may differ by the reordering error of its sum, held to
1e-6 of the summed magnitude |table| + sum|rows| (scaled by that sum,
since the entries near 0 of a sum of large terms carry the large terms'
rounding).  bfloat16 tables: both round the rows to bf16, sum in float32
and round once into the table (the JAX case runs with chunk >= N, so each
group is one visit and one rounding there too); a float32 sum in another
order can land on the other side of a bf16 rounding edge, so an entry may
differ by one bf16 ulp of the result and by no more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.kernels.group_rmw import group_plan as jplan
from word2bits_tpu.kernels.group_rmw import scatter_add_grmw as jgrmw
from word2bits_tpu.kernels.group_rmw import \
    scatter_add_grmw_planned as jgrmw_planned
from word2bits_tpu_torch.kernels import group_rmw as tg

SENTINEL = 0x7FFFFFF0


def _case(rng, V, C, N, dup_heavy=False):
    table = rng.normal(size=(V, C)).astype(np.float32)
    if dup_heavy:
        ids = np.minimum(rng.zipf(1.1, size=N) - 1, V - 1).astype(np.int32)
    else:
        ids = rng.integers(0, V, size=N).astype(np.int32)
    rows = rng.normal(size=(N, C)).astype(np.float32)
    return table, ids, rows


def _magnitude(table, ids, rows):
    """|table| + sum over each id's rows of |row|: the scale of an entry's
    float32 sum."""
    mag = np.abs(table).astype(np.float64)
    keep = (ids >= 0) & (ids < table.shape[0])
    np.add.at(mag, ids[keep], np.abs(rows[keep]))
    return mag


def _assert_f32_close(got, want, table, ids, rows):
    err = np.abs(got.astype(np.float64) - want)
    bound = 1e-6 * _magnitude(table, ids, rows)
    assert np.all(err <= bound), float((err / np.maximum(bound, 1e-30)).max())


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _jax(table, ids, rows, **kw):
    return np.asarray(jgrmw(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(rows), interpret=True, **kw))


def _port(table, ids, rows, **kw):
    return tg.scatter_add_grmw(torch.from_numpy(table.copy()),
                               torch.from_numpy(ids),
                               torch.from_numpy(rows), **kw).numpy()


@pytest.mark.parametrize("V,C,N,chunk,slots", [
    (1024, 256, 777, 128, 16),       # N not a chunk multiple
    (1024, 256, 64, 128, 16),        # N < chunk
    (512, 128, 2048, 64, 8),         # many chunks, few groups
    (2048, 256, 1500, 128, 4),       # few slots (deep reuse)
    (64, 128, 500, 128, 16),         # more slots than groups
])
@pytest.mark.parametrize("dup_heavy", [False, True])
def test_grmw_matches_jax(rng, V, C, N, chunk, slots, dup_heavy):
    table, ids, rows = _case(rng, V, C, N, dup_heavy)
    want = _jax(table, ids, rows, chunk=chunk, slots=slots)
    got = _port(table, ids, rows, chunk=chunk, slots=slots)
    _assert_f32_close(got, want, table, ids, rows)


def test_sparse_tail(rng):
    """Few ids over many groups: every visit is its own group."""
    V, C, N = 16384, 128, 200
    table = rng.normal(size=(V, C)).astype(np.float32)
    ids = (rng.integers(0, 64, size=N) * 251).astype(np.int32)  # gappy
    rows = rng.normal(size=(N, C)).astype(np.float32)
    _assert_f32_close(_port(table, ids, rows), _jax(table, ids, rows),
                      table, ids, rows)


def test_group_spans_chunk_boundary(rng):
    """One hot group spans many of the JAX kernel's blocks (visited once
    per block there, ordered by its drain); the port sums each of its ids
    over the whole sorted stream."""
    V, C, N = 512, 128, 640
    table = rng.normal(size=(V, C)).astype(np.float32)
    ids = rng.integers(0, 8, size=N).astype(np.int32)   # all in group 0
    rows = rng.normal(size=(N, C)).astype(np.float32)
    want = _jax(table, ids, rows, chunk=64, slots=8)
    got = _port(table, ids, rows, chunk=64, slots=8)
    _assert_f32_close(got, want, table, ids, rows)


@pytest.mark.parametrize("dup_heavy", [False, True])
def test_bf16_table(rng, dup_heavy):
    V, C, N = 1024, 256, 900
    table, ids, rows = _case(rng, V, C, N, dup_heavy)
    t16 = np.asarray(jnp.asarray(table, jnp.bfloat16))   # JAX donates
    want = np.asarray(jgrmw(jnp.asarray(t16), jnp.asarray(ids),
                            jnp.asarray(rows), chunk=1024, slots=16,
                            interpret=True), np.float32)
    got = tg.scatter_add_grmw(
        torch.from_numpy(t16.view(np.int16).copy()).view(torch.bfloat16),
        torch.from_numpy(ids), torch.from_numpy(rows)).to(
        torch.float32).numpy()
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    assert (got != want).mean() < 0.01


def test_drop_sentinel(rng):
    """ids >= V (the pad/drop sentinel) are dropped, like mode='drop'."""
    V, C, N = 512, 128, 300
    table, ids, rows = _case(rng, V, C, N)
    ids[::7] = SENTINEL
    ids[3] = V + 5      # any id >= V
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].add(
        jnp.asarray(rows), mode="drop"))
    _assert_f32_close(_port(table, ids, rows), want, table, ids, rows)
    ids[3] = SENTINEL
    _assert_f32_close(_port(table, ids, rows), _jax(table, ids, rows),
                      table, ids, rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpadded_vocab(rng, dtype):
    """The port takes any V; the JAX kernel needs V % grp == 0, so it gets
    a zero-padded copy whose padding rows stay zero and are trimmed."""
    V, C, N = 1001, 128, 700
    table, ids, rows = _case(rng, V, C, N, dup_heavy=True)
    ids[-5:] = V - 1          # the last, partial group
    jdt = jnp.dtype(dtype)
    jt = np.asarray(jnp.pad(jnp.asarray(table, jdt),    # JAX donates
                            ((0, (-V) % (32 // jdt.itemsize)), (0, 0))))
    want = np.asarray(jgrmw(jnp.asarray(jt), jnp.asarray(ids),
                            jnp.asarray(rows), chunk=1024, slots=16,
                            interpret=True), np.float32)
    assert not want[V:].any()
    want = want[:V]
    tt = torch.from_numpy(jt[:V].view(
        np.int16 if dtype == "bfloat16" else np.float32).copy())
    if dtype == "bfloat16":
        tt = tt.view(torch.bfloat16)
    got = tg.scatter_add_grmw(tt, torch.from_numpy(ids),
                              torch.from_numpy(rows)).to(torch.float32)
    if dtype == "bfloat16":
        assert np.all(np.abs(got.numpy() - want) <= _bf16_ulp(want))
    else:
        _assert_f32_close(got.numpy(), want, table, ids, rows)


def test_planned_batched_matches_jax_scan(rng):
    """The hoisted batched plan over S steps, applied step by step == the
    JAX package's vmapped plans consumed by lax.scan."""
    V, C, N, S = 512, 128, 300, 3
    table = rng.normal(size=(V, C)).astype(np.float32)
    ids_all = rng.integers(0, V, size=(S, N)).astype(np.int32)
    rows_all = rng.normal(size=(S, N, C)).astype(np.float32)
    plans = jax.vmap(lambda i: jplan(i, 8))(jnp.asarray(ids_all))

    def step(tab, xs):
        plan, rows = xs
        return jgrmw_planned(tab, plan, rows, interpret=True), ()

    want, _ = jax.lax.scan(step, jnp.asarray(table),
                           (plans, jnp.asarray(rows_all)))
    tplans = tg.sort_plan(torch.from_numpy(ids_all))
    got = torch.from_numpy(table.copy())
    for s in range(S):
        tg.scatter_add_grmw_planned(got, tplans.step(s),
                                    torch.from_numpy(rows_all[s]))
    _assert_f32_close(got.numpy(), np.asarray(want), table,
                      ids_all.reshape(-1), rows_all.reshape(-1, C))


def test_chunk_below_slots_raises(rng):
    table, ids, rows = _case(rng, 64, 16, 40)
    args = (torch.from_numpy(table), torch.from_numpy(ids),
            torch.from_numpy(rows))
    with pytest.raises(ValueError, match="slots"):
        tg.scatter_add_grmw(*args, chunk=8, slots=16)
    plan = tg.sort_plan(args[1])
    with pytest.raises(ValueError, match="slots"):
        tg.scatter_add_grmw_planned(args[0], plan, args[2], chunk=8,
                                    slots=16)
    tg.scatter_add_grmw(*args, chunk=16, slots=16)    # equal is fine


def test_wrapper_counts_only_launches(rng):
    table, ids, rows = _case(rng, 64, 16, 40)
    before = tg.scatter_add_grmw_planned.launches
    _port(table, ids, rows)           # CPU: plain version, no launch
    assert tg.scatter_add_grmw_planned.launches == before


@pytest.mark.parametrize("V,C,N,head,n_sentinel", [
    (320, 128, 700, 0.8, 7), (64, 128, 400, 1.0, 0), (320, 37, 700, 0.8, 7)])
def test_grmw_matches_jax_dominant_head(rng, V, C, N, head, n_sentinel):
    """One id holding most rows (80%, beside uniform ids and drop
    sentinels) or all of them: the Zipf head whose run the kernel cuts
    into pieces over many tiles; C = 37 is no multiple of 4 (one column a
    thread)."""
    table, ids, rows = _case(rng, V, C, N)
    ids[rng.random(N) < head] = 3
    ids[rng.choice(N, n_sentinel, replace=False)] = SENTINEL
    want = _jax(table, ids, rows)
    got = _port(table, ids, rows)
    _assert_f32_close(got, want, table, ids, rows)


def test_grmw_drops_negative_ids(rng):
    """Negative ids sort first in the plan and are dropped, as ids >= V
    are (the JAX package's mode='drop')."""
    V, C, N = 256, 37, 500
    table, ids, rows = _case(rng, V, C, N, dup_heavy=True)
    ids[::11] = -1
    ids[5::13] = SENTINEL
    want = table.astype(np.float64)
    keep = (ids >= 0) & (ids < V)
    np.add.at(want, ids[keep], rows[keep])
    got = _port(table, ids, rows)
    _assert_f32_close(got, want, table, ids, rows)
    plan = tg.sort_plan(torch.from_numpy(ids))
    assert (plan.sids[:int((ids < 0).sum())] < 0).all()


def _bad_grmw_call(rng, bad):
    """(table, plan, rows) of a scatter that the kernel does not take."""
    V, C, N = 64, 16, 40
    table, ids, rows = _case(rng, V, C, N, dup_heavy=True)
    table, rows = torch.from_numpy(table), torch.from_numpy(rows)
    plan = tg.sort_plan(torch.from_numpy(ids))
    if bad == "table dtype":
        table = table.double()
    elif bad == "row dtype":
        rows = rows.to(torch.float16)
    elif bad == "bf16 rows into a float32 table":
        rows = rows.to(torch.bfloat16)
    elif bad == "width":
        rows = rows[:, :C - 1]
    elif bad == "batched plan":
        plan = tg.sort_plan(torch.from_numpy(ids)[None])
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
def test_grmw_wrapper_raises_on_what_the_kernel_does_not_take(rng, bad):
    """The checks kernel 7's wrapper makes before a launch (on a CUDA
    tensor it launches the kernel or raises; it does not fall back)."""
    table, plan, rows = _bad_grmw_call(rng, bad)
    with pytest.raises(ValueError, match="scatter_add_grmw"):
        tg._check("scatter_add_grmw", table, plan, rows)


def test_grmw_check_takes_a_good_call(rng):
    table, plan, rows = _bad_grmw_call(rng, "none")
    tg._check("scatter_add_grmw", table, plan, rows)
    tg._check("scatter_add_grmw", table.to(torch.bfloat16), plan,
              rows.to(torch.bfloat16))


def test_grmw_wrapper_raises_off_cpu_and_cuda(rng):
    table, plan, rows = _bad_grmw_call(rng, "none")
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        tg.scatter_add_grmw_planned(table.to("meta"), plan, rows.to("meta"))
