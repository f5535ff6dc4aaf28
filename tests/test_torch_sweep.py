"""Kernel 9's module (word2bits_tpu_torch/kernels/sweep_scatter.py) == the
JAX swept scatter (kernels/sweep_scatter.py, interpret mode, CPU).

On a CPU tensor the wrapper runs its plain version (the CUDA kernel runs
only on the card, where chip_smoke.py holds it against the plain version
bit for bit).  The plan is the JAX plan, slot for slot.  The scatter sums
each (block, window) run in float32 in slot order, where the JAX kernel's
one-hot matmul sums in its own order: float32 atol 1e-5 plus rtol 1e-6
for the Zipf-heavy sums of hundreds of rows (the JAX suite states atol
1e-4 + rtol 1e-5 against the per-row scatter), bfloat16 within one bf16
rounding.  The port takes any V (ceil(V / window) windows), which the JAX
entry point refuses: that case is held against index_add_.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.kernels import sweep_scatter as jsweep
from word2bits_tpu_torch.kernels import sweep_scatter as tsweep

SENTINEL = 0x7FFFFFF0
CASES = [
    (1024, 256, 777, 512, 128),      # N not a chunk multiple
    (1024, 256, 64, 512, 128),       # N < chunk
    (512, 128, 2048, 128, 64),       # small windows, many chunks/window
    (2048, 256, 1500, 1024, 128),    # wide windows
]


def _case(rng, V, C, N, dup_heavy, n_sentinel=0):
    table = rng.normal(size=(V, C)).astype(np.float32)
    if dup_heavy:
        ids = np.minimum(rng.zipf(1.1, size=N) - 1, V - 1).astype(np.int32)
    else:
        ids = rng.integers(0, V, size=N).astype(np.int32)
    ids[rng.choice(N, n_sentinel, replace=False)] = SENTINEL
    rows = rng.normal(size=(N, C)).astype(np.float32)
    return table, ids, rows


def _jax(table, ids, rows, window, chunk, dtype=jnp.float32):
    """The JAX sweep (it donates its table: a fresh array each call)."""
    return np.asarray(jsweep.scatter_add_sweep(
        jnp.asarray(table, dtype), jnp.asarray(ids),
        jnp.asarray(rows, dtype), window=window, chunk=chunk,
        interpret=True).astype(jnp.float32))


def _f32(x, dtype):
    """x rounded to dtype, as float32 numpy."""
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))


def _port(table, ids, rows, window, chunk):
    return tsweep.scatter_add_sweep(
        table, torch.from_numpy(ids), torch.from_numpy(rows), window=window,
        chunk=chunk)


@pytest.mark.parametrize("V,C,N,window,chunk", CASES)
@pytest.mark.parametrize("dup_heavy", [False, True])
def test_plan_is_the_jax_plan(rng, V, C, N, window, chunk, dup_heavy):
    _, ids, _ = _case(rng, V, C, N, dup_heavy, n_sentinel=N // 20)
    g, poffs, meta, first = jsweep.sweep_plan(jnp.asarray(ids), V, window,
                                              chunk)
    plan = tsweep.sweep_plan(torch.from_numpy(ids), V, window, chunk)
    np.testing.assert_array_equal(plan.order.numpy(), np.asarray(g))
    np.testing.assert_array_equal(plan.offs.numpy(),
                                  np.asarray(poffs)[:, 0, :].reshape(-1))
    np.testing.assert_array_equal(plan.meta.numpy(), np.asarray(meta))
    # the blocks of each window, as the kernel walks them: where JAX's
    # `first` flags a window's first block
    wc = plan.win_chunk.numpy()
    m = plan.meta.numpy()
    for w in range(V // window):
        assert np.all(m[wc[w]:wc[w + 1]] == w)
    starts = np.unique(wc[:-1][wc[:-1] < wc[1:]])
    np.testing.assert_array_equal(np.flatnonzero(np.asarray(first))[
        :starts.size], starts)


@pytest.mark.parametrize("V,C,N,window,chunk", CASES)
@pytest.mark.parametrize("dup_heavy", [False, True])
def test_plain_matches_pallas_f32(rng, V, C, N, window, chunk, dup_heavy):
    table, ids, rows = _case(rng, V, C, N, dup_heavy, n_sentinel=N // 20)
    want = _jax(table, ids, rows, window, chunk)
    got = _port(torch.from_numpy(table.copy()), ids, rows, window, chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
    # and the table-dtype contract: plain entry point == planned entry point
    plain = tsweep.scatter_add_sweep_plain(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(rows), window, chunk)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("V,C,N,window,chunk", CASES[:3])
def test_plain_matches_pallas_bf16(rng, V, C, N, window, chunk):
    """bf16 table, rows cast to bf16 first (as the JAX fused step casts
    them): one bf16 rounding per block apart at most."""
    table, ids, rows = _case(rng, V, C, N, True, n_sentinel=5)
    want = _jax(table, ids, rows, window, chunk, jnp.bfloat16)
    tt = torch.from_numpy(_f32(table, jnp.bfloat16)).to(torch.bfloat16)
    got = _port(tt, ids, rows, window, chunk).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_id_spanning_two_blocks(rng, dtype):
    """One id with 200 rows over chunk 128: its rows span two blocks, and
    the table takes two adds (two roundings in bf16), as on the TPU."""
    V, C, window, chunk = 512, 128, 256, 128
    ids = np.concatenate([np.full(200, 7), rng.integers(0, V, 60)]
                         ).astype(np.int32)
    rng.shuffle(ids)
    rows = rng.normal(size=(ids.size, C)).astype(np.float32)
    table = rng.normal(size=(V, C)).astype(np.float32)
    plan = tsweep.sweep_plan(torch.from_numpy(ids), V, window, chunk)
    blocks = plan.offs.numpy().reshape(-1, chunk)
    assert sum(bool((b == 7).any()) for b in blocks) == 2
    t_dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _jax(table, ids, rows, window, chunk, t_dt)
    tt = torch.from_numpy(_f32(table, t_dt)).to(getattr(torch, dtype))
    got = _port(tt, ids, rows, window, chunk).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -7)
        # two roundings: the sum of the first block's rows, rounded into
        # the row, then the second's
        s = torch.from_numpy(rows).to(torch.bfloat16).float()
        order = plan.order.numpy().reshape(-1, chunk)
        row = torch.from_numpy(table[7]).to(torch.bfloat16)
        for b, o in zip(blocks, order):
            sel = o[b == 7]
            if sel.size:
                acc = torch.zeros(C)
                for r in sel:
                    acc = acc + s[r]
                row = (row.float() + acc).to(torch.bfloat16)
        np.testing.assert_array_equal(got[7], row.float().numpy())


@pytest.mark.parametrize("V,window", [(1000, 512), (300, 128), (70, 64)])
def test_any_vocabulary_size(rng, V, window):
    """V % window != 0 (the JAX entry point raises; the port counts
    ceil(V / window) windows): == index_add_, sentinels and negative ids
    dropped."""
    C, N = 24, 900
    table, ids, rows = _case(rng, V, C, N, True, n_sentinel=30)
    ids[:4] = [V, V + 3, -1, V - 1]
    with pytest.raises(ValueError, match="window"):
        jsweep.scatter_add_sweep(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(rows), window=window,
                                 interpret=True)
    keep = (ids >= 0) & (ids < V)
    want = torch.from_numpy(table.copy()).index_add_(
        0, torch.from_numpy(ids[keep]).long(), torch.from_numpy(rows[keep]))
    got = _port(torch.from_numpy(table.copy()), ids, rows, window, 128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-6)
    plan = tsweep.sweep_plan(torch.from_numpy(ids), V, window, 128)
    assert plan.win_chunk.numel() == -(-V // window) + 1


def test_wrapper_counts_only_launches_and_rejects(rng):
    table, ids, rows = _case(rng, 256, 8, 50, False)
    before = tsweep.scatter_add_sweep_planned.launches
    _port(torch.from_numpy(table), ids, rows, 128, 32)   # CPU: plain
    assert tsweep.scatter_add_sweep_planned.launches == before
    with pytest.raises(ValueError, match="positive"):
        tsweep.sweep_plan(torch.from_numpy(ids), 256, 0, 32)
    with pytest.raises(ValueError, match="one step"):
        tsweep.sweep_plan(torch.from_numpy(ids)[None], 256)
    with pytest.raises(ValueError, match="meta"):
        tsweep.scatter_add_sweep(torch.zeros((4, 4), device="meta"),
                                 torch.zeros(2, dtype=torch.long),
                                 torch.zeros((2, 4)))


def test_fused_chunk_sweep_matches_jax_steps(rng):
    """The port's fused chunk with scatter_impl='sweep' on injected draws
    == the JAX fused_slab_step with 'sweep' step by step, on the table the
    JAX kernel needs (rows padded to a multiple of 512, columns to 128),
    trimmed through params_from_jax; atol/rtol 1e-4 as the JAX suite."""
    from word2bits_tpu.models.cbow import CBOWHyper as JHyper
    from word2bits_tpu.models.cbow_fused import fused_slab_step as jstep
    from word2bits_tpu.models.cbow_slab import SlabInputs as JInputs
    from word2bits_tpu_torch.models import cbow_fused as tf
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.sampling.unigram import build_alias_table

    V, D, B, W, K, G, S, P = 300, 16, 64, 3, 5, 8, 3, 2
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
    cp, vp = (-2 * D) % 128, (-V) % 512
    jt = jnp.pad(jnp.asarray(table), ((0, vp), (0, cp)))
    wloss = 0.0
    for s in range(S):
        wca = jnp.float32(sc.wca_start) + jnp.float32(s) * jnp.float32(
            sc.wca_per_step)
        alpha = jnp.float32(sc.alpha0) * (1.0 - wca / jnp.float32(sc.denom))
        alpha = jnp.maximum(alpha, jnp.float32(sc.alpha0) * 1e-4)
        lo = sc.base0 + s * B - W
        inputs = JInputs(slab_tokens=jnp.asarray(tokens[lo:lo + B + 2 * W]),
                         slab_sents=jnp.asarray(sents[lo:lo + B + 2 * W]),
                         shrink=jnp.asarray(shrinks[s].astype(np.int32)),
                         neg_ids=jnp.asarray(negs[s].astype(np.int32)))
        jt, l = jstep(jt, inputs, alpha, JHyper(**hyper_kw), B, G,
                      neg_pool=P, banded=8, scatter_impl="sweep",
                      context_pallas=True, col_pad=cp)
        wloss += float(l)
    jax.block_until_ready(jt)
    assert float(jnp.abs(jt[V:]).max()) == 0.0
    want = tf.params_from_jax(np.asarray(jt), dtype=torch.float32,
                              device="cpu", table_pad=(vp, cp))

    chunk = tf.make_fused_train_chunk(CBOWHyper(**hyper_kw), V, B, S,
                                      neg_sharing=G, neg_pool=P, banded=8,
                                      scatter_impl="sweep",
                                      context_pallas=True)
    got, loss = chunk(torch.from_numpy(table.copy()),
                      torch.from_numpy(tokens).long(),
                      torch.from_numpy(sents).long(),
                      build_alias_table(np.ones(V)), sc,
                      shrinks=torch.from_numpy(shrinks),
                      negs=torch.from_numpy(negs))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(loss), wloss, rtol=1e-5, atol=1e-3)
