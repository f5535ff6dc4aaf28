"""The port's sharded chunk == the port's single-device chunk on the same
generator seed, and the sharded trainer's wiring (CPU).

Every shard of a LocalMesh seeds its own torch.Generator as the
single-device chunk's is seeded, and draws the global shrinks and
negatives in make_slab_train_chunk's order (parallel/chunk.py), so the
two runs consume the same numbers; they differ only in summation order.
Tolerances are the JAX suite's for its sharded-chunk == single-chunk
tests (tests/test_sharded_chunk.py:83-87): tables atol 3e-5, loss rtol
1e-4, atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from word2bits_tpu_torch.config import Word2BitsConfig
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.models.cbow_fused import (deinterleave, interleave,
                                                   make_fused_train_chunk)
from word2bits_tpu_torch.models.cbow_slab import make_slab_train_chunk
from word2bits_tpu_torch.models.skipgram import make_skipgram_train_chunk
from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
from word2bits_tpu_torch.parallel.mesh import LocalMesh
from word2bits_tpu_torch.parallel.sharded import pad_vocab_rows, shard_params
from word2bits_tpu_torch.parallel.sharded_skipgram import \
    _sharded_skipgram_body
from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body
from word2bits_tpu_torch.parallel.trainer import ShardedTrainer
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  build_stratified_tables)

S, B, W, K, V, D, H = 3, 32, 3, 4, 45, 16, 12
SEED = 5


def _setup(seed):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32))
    n = W + S * B + W
    toks = rng.integers(1, V, n)
    sents = np.sort(rng.integers(0, 6, n))
    toks[:2] = -1
    sents[:2] = -1
    weights = rng.integers(1, 50, V).astype(np.float64) ** 0.75
    scalars = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                           wca_per_step=250.0, denom=1e5)
    return u, v, torch.from_numpy(toks), torch.from_numpy(sents), weights, \
        scalars


def _sharded(body, mesh_shape, u, v, toks, sents, atab, scalars, **kw):
    """The sharded chunk on a LocalMesh, each shard's generator seeded
    SEED; whole (u, v) and the loss."""
    mesh = LocalMesh.of(mesh_shape)
    up, vp = pad_vocab_rows(u, mesh.nv), pad_vocab_rows(v, mesh.nv)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    chunk = make_sharded_chunk(body, hyper, mesh, up.shape[0], V, B, S, **kw)

    def shard(comm):
        ul, vl = shard_params(up, vp, comm)
        gen = torch.Generator().manual_seed(SEED)
        return chunk(comm, ul, vl, toks, sents, atab, scalars, gen)

    res = mesh.run(shard)
    assert len({float(r[2]) for r in res}) == 1
    return (torch.cat([res[j][0] for j in range(mesh.nv)])[:V],
            torch.cat([res[j][1] for j in range(mesh.nv)])[:V],
            float(res[0][2]))


def _close(got, want):
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=3e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=3e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)


# (mesh, G, P, model, keywords of both chunks)
CASES = [
    ({"data": 2, "vocab": 2}, 8, 1, "cbow", {}),
    ({"data": 1, "vocab": 4}, 0, 1, "cbow", {}),
    ({"data": 4, "vocab": 1}, 8, 4, "cbow", {}),
    ({"data": 2, "vocab": 2}, 8, 2, "cbow", dict(scatter_impl="span",
                                                  banded=8)),
    ({"data": 2, "vocab": 2}, 0, 1, "cbow", dict(scatter_impl="span")),
    ({"data": 2, "vocab": 2}, 8, 4, "skipgram", {}),
]


@pytest.mark.parametrize("mesh_shape,G,P,model,kw", CASES)
def test_sharded_chunk_equals_single_chunk(mesh_shape, G, P, model, kw):
    u, v, toks, sents, weights, scalars = _setup(0)
    atab = build_alias_table(weights)
    if model == "skipgram":
        single = make_skipgram_train_chunk(
            CBOWHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.01),
            V, B, S, neg_sharing=G, neg_pool=P)
    else:
        single = make_slab_train_chunk(
            CBOWHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.01),
            V, B, S, neg_sharing=G, neg_pool=P, **kw)
    want = single(u.clone(), v.clone(), toks, sents, atab, scalars,
                  torch.Generator().manual_seed(SEED))
    body = _sharded_skipgram_body if model == "skipgram" \
        else _sharded_slab_body
    got = _sharded(body, mesh_shape, u, v, toks, sents, atab, scalars,
                   neg_sharing=G, neg_pool=P, **kw)
    _close(got, (want[0], want[1], float(want[2])))


def test_rmw_chunk_equals_single_chunk():
    """The rmw route (kernel 8's plain version) on a pure vocab mesh, one
    step a chunk as the capacity path runs it."""
    u, v, toks, sents, weights, scalars = _setup(1)
    atab = build_alias_table(weights)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    gen = torch.Generator().manual_seed(SEED)
    single = make_slab_train_chunk(hyper, V, B, S, neg_sharing=8)
    want = single(u.clone(), v.clone(), toks, sents, atab, scalars, gen)
    got = _sharded(_sharded_slab_body, {"vocab": 4}, u, v, toks, sents,
                   atab, scalars, neg_sharing=8, rmw=True)
    _close(got, (want[0], want[1], float(want[2])))


@pytest.mark.parametrize("model,G", [("cbow", 8), ("skipgram", 0)])
def test_sharded_dense_hot_chunk_equals_single(model, G):
    """Dense-hot negatives (cold draws at offset H, the exact hot head per
    vocab shard) against the single-device dense-hot chunk: the fused
    engine's for CBOW (without a cold map: the plain slab scatter),
    skip-gram's own."""
    u, v, toks, sents, weights, scalars = _setup(2)
    st = build_stratified_tables(weights, H)
    dh = st.dense_split(K)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    gen = torch.Generator().manual_seed(SEED)
    if model == "cbow":
        single = make_fused_train_chunk(hyper, V, B, S, neg_sharing=G,
                                        hot_rows=H, dense_hot=dh)
        table, loss = single(interleave(u, v), toks, sents, st.cold,
                             scalars, gen)
        want = (*deinterleave(table), float(loss))
        body = _sharded_slab_body
    else:
        single = make_skipgram_train_chunk(hyper, V, B, S, neg_sharing=G,
                                           hot_rows=H, dense_hot=dh)
        u1, v1, loss = single(u.clone(), v.clone(), toks, sents, st.cold,
                              scalars, gen)
        want = (u1, v1, float(loss))
        body = _sharded_skipgram_body
    got = _sharded(body, {"data": 2, "vocab": 2}, u, v, toks, sents,
                   st.cold, scalars, neg_sharing=G, dense_hot=dh, hot_rows=H)
    _close(got, want)


def _cfg(**kw):
    base = dict(train_file="x", output_file="y", bitlevel=1, size=D,
                window=W, negative=K, batch_size=B, neg_sharing=8,
                steps_per_chunk=2, mesh_shape={"data": 2, "vocab": 2})
    base.update(kw)
    return Word2BitsConfig(**base)


def test_trainer_layout_and_params_roundtrip():
    """-neg-dense-hot places the rows in the balanced layout (-hot-interleave
    1, the default), params() gives rank 0 the whole tables in global order,
    the other ranks None; -hot-interleave 0 keeps contiguous blocks."""
    rng = np.random.default_rng(0)
    u = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32)
    st = build_stratified_tables(rng.integers(1, 50, V) ** 0.75, H)
    for interleave_flag in (True, False):
        cfg = _cfg(hot_rows=H, neg_dense_hot=True,
                   hot_interleave=interleave_flag)

        def shard(comm):
            from word2bits_tpu_torch.parallel.layout import to_layout
            from word2bits_tpu_torch.parallel.trainer import shard_layout
            Vp, layout = shard_layout(cfg, V, comm.nv)
            up, vp = pad_vocab_rows(u, comm.nv), pad_vocab_rows(v, comm.nv)
            if layout is not None:
                up, vp = to_layout(up, layout), to_layout(vp, layout)
            tr = ShardedTrainer(cfg, V, comm, *shard_params(up, vp, comm),
                                dense_hot=st.dense_split(K))
            return tr.layout, tr.params()

        res = LocalMesh(2, 2).run(shard)
        assert (res[0][0] is not None) == interleave_flag
        assert all(r[1] is None for r in res[1:])
        np.testing.assert_array_equal(res[0][1][0].numpy(), u)
        np.testing.assert_array_equal(res[0][1][1].numpy(), v)


def test_trainer_checks_its_tables():
    """A shard's tables must hold its rows; dense_hot comes exactly with
    -neg-dense-hot (the config leaves no other sampler on a mesh:
    -neg-stratify needs -hot-rows, which a mesh takes only with
    -neg-dense-hot)."""
    with pytest.raises(ValueError, match="with -mesh-shape, -hot-rows"):
        _cfg(hot_rows=H, neg_stratify=True)
    with pytest.raises(ValueError, match="shard holds"):
        LocalMesh(1, 2).run(lambda comm: ShardedTrainer(
            _cfg(mesh_shape={"vocab": 2}), V, comm, torch.zeros(V, D),
            torch.zeros(V, D)))
    with pytest.raises(ValueError, match="dense_hot"):
        LocalMesh(1, 1).run(lambda comm: ShardedTrainer(
            _cfg(mesh_shape={"vocab": 1}), V, comm, torch.zeros(V, D),
            torch.zeros(V, D), dense_hot=(1, 1.0, np.ones(4))))


def test_one_shard_mesh_train_equals_single_device(tmp_path):
    """train() with -mesh-shape data=1,vocab=1 in a plain process: a
    one-rank gloo group of its own (destroyed at the end), the same draws
    as the single-device slab engine, the same tables up to summation
    order; the vector file is written."""
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(40)]
    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(" ".join(rng.choice(words, 12))
                                for _ in range(300)) + "\n")
    from word2bits_tpu_torch.train import train
    base = dict(train_file=str(corpus), bitlevel=1, size=D, window=W,
                negative=K, iter=2, min_count=1, batch_size=B,
                steps_per_chunk=4, neg_sharing=8, neg_pool=2, debug=0,
                scatter_impl="span", banded_tile=8)
    single = train(Word2BitsConfig(**base), device="cpu")
    out = tmp_path / "v.bin"
    mesh = train(Word2BitsConfig(**base, output_file=str(out), binary=True,
                                 mesh_shape={"data": 1, "vocab": 1}),
                 device="cpu")
    assert not torch.distributed.is_initialized()
    assert mesh.steps == single.steps
    for a, b in zip(mesh.tables, single.tables):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
    np.testing.assert_allclose(mesh.epoch_losses, single.epoch_losses,
                               rtol=1e-4)
    from word2bits_tpu_torch.io.vectors import read_vectors
    ws, vecs = read_vectors(str(out))
    assert ws == mesh.vocab.words
    assert set(np.unique(np.abs(vecs))) == {np.float32(1) / np.float32(3)}
    # the fused flag is ignored on a mesh, as in the JAX package
    assert not dataclasses.replace(
        Word2BitsConfig(**base), fused_tables=True,
        mesh_shape={"vocab": 1}).fused_on


def test_checkpoint_rows_of_a_shard(tmp_path):
    """load_checkpoint(ranges=...) reads a shard's row ranges of a
    state.npz (the balanced layout's two ranges here), rows past the
    vocabulary zero."""
    from word2bits_tpu_torch.train import load_checkpoint, save_checkpoint
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.uniform(-1, 1, (V, D)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 1, (V, D)).astype(np.float32))
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, (u, v), 0, torch.Generator(), 0.0)
    ranges = [(3, 9), (40, 50)]
    ck = load_checkpoint(path, _cfg(), "cpu", ranges)
    assert ck.vocab_rows == V and ck.tables[0].shape == (16, D)
    for got, want in zip(ck.tables, (u, v)):
        assert torch.equal(got[:6], want[3:9])
        assert torch.equal(got[6:11], want[40:45])
        assert (got[11:] == 0).all()


def test_one_shard_mesh_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A mesh run resumed from its epoch-0 checkpoint (each rank reading
    its rows, the generator's state restored) equals the uninterrupted
    run bit for bit, as on one device (tests/test_torch_checkpoint.py)."""
    import os
    import shutil

    from word2bits_tpu_torch import train as ttrain
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(30)]
    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(" ".join(rng.choice(words, 10))
                                for _ in range(200)) + "\n")
    real = ttrain.save_checkpoint

    def keep_epoch0(path, tables, epoch, gen, words_done):
        real(path, tables, epoch, gen, words_done)
        if epoch == 0:
            shutil.copy(path, tmp_path / "epoch0.npz")

    monkeypatch.setattr(ttrain, "save_checkpoint", keep_epoch0)
    base = dict(train_file=str(corpus), size=D, window=W, negative=K,
                min_count=1, batch_size=B, steps_per_chunk=4, iter=2,
                neg_sharing=8, debug=0, mesh_shape={"vocab": 1})
    whole = ttrain.train(Word2BitsConfig(
        **base, checkpoint_dir=str(tmp_path / "ck")), device="cpu")
    os.makedirs(tmp_path / "ck2")
    shutil.copy(tmp_path / "epoch0.npz", tmp_path / "ck2" / "state.npz")
    resumed = ttrain.train(Word2BitsConfig(
        **base, checkpoint_dir=str(tmp_path / "ck2"), resume=True),
        device="cpu")
    assert resumed.start_epoch == 1
    assert resumed.epoch_losses == whole.epoch_losses[1:]
    for a, b in zip(resumed.tables, whole.tables):
        assert torch.equal(a, b)
