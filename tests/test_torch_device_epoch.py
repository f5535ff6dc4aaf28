"""The port's device epoch (data/device_pipeline.py) on the CPU.

Given the same float32 uniforms, its arrays are bit-equal to the port's
host build (data/pipeline.build_epoch_arrays, `uniforms=`) and to the JAX
package's build_with_uniforms, in tests/test_device_pipeline.py's three
cases and its long-sentence re-segmentation; a capacity smaller than the
kept words drops the overflow as the JAX `mode="drop"` store does.  The
training loop builds every epoch there under the auto -device-epoch, over
one or several segments, with no cold map under -neg-dense-hot.
"""

import numpy as np
import pytest
import torch

from word2bits_tpu.data.device_pipeline import \
    build_with_uniforms as jbuild
from word2bits_tpu_torch.config import Word2BitsConfig
from word2bits_tpu_torch.data import device_pipeline as tdp
from word2bits_tpu_torch.data.pipeline import (build_epoch_arrays,
                                               subsample_keep_probs)
from word2bits_tpu_torch import train as ttrain


def _corpus(rng, n, v, sent_every=40):
    """Zipf-ish ids with `</s>` (id 0) breaks sprinkled in."""
    ids = np.minimum(rng.zipf(1.3, size=n) - 1, v - 2).astype(np.int32) + 1
    ids[rng.random(n) < 1.0 / sent_every] = 0
    return ids


def _three_way(encoded, counts, sample, capacity, window, uniforms):
    tw = int(counts.sum())
    kp = subsample_keep_probs(counts, sample, tw)
    host = build_epoch_arrays(encoded, counts, sample, tw, window, None,
                              capacity=capacity, uniforms=uniforms)
    dt, ds, dn = tdp.build_with_uniforms(capacity, window, encoded, kp,
                                         uniforms, device="cpu")
    jt, js, jn = jbuild(capacity, window, encoded, kp, uniforms)
    assert dt.dtype == ds.dtype == torch.int32
    assert int(dn) == host.n_tokens == int(jn)
    for got in (host.tokens, np.asarray(jt)):
        np.testing.assert_array_equal(dt.numpy(), got)
    for got in (host.sent_ids, np.asarray(js)):
        np.testing.assert_array_equal(ds.numpy(), got)
    return dt.numpy(), ds.numpy(), int(dn)


@pytest.mark.parametrize("n,v,sample", [
    (5_000, 200, 1e-3),
    (5_000, 200, 0.0),      # subsampling disabled
    (3_000, 50, 1e-2),      # aggressive subsampling
])
def test_device_epoch_equals_host_and_jax(n, v, sample):
    rng = np.random.default_rng(7)
    encoded = _corpus(rng, n, v)
    counts = np.bincount(encoded, minlength=v).astype(np.int64)
    counts[0] = 0
    capacity = ((n + 1023) // 1024) * 1024
    _three_way(encoded, counts, sample, capacity, 5,
               rng.random(n, dtype=np.float32))


def test_long_sentence_resegmentation():
    """No `</s>`: sentences split every MAX_SENTENCE_LENGTH kept words."""
    n, v = 4_096, 100
    rng = np.random.default_rng(3)
    encoded = rng.integers(1, v, size=n).astype(np.int32)
    counts = np.bincount(encoded, minlength=v).astype(np.int64)
    _, ds, dn = _three_way(encoded, counts, 1e-3, 4_096, 5,
                           np.zeros(n, np.float32))     # keep everything
    assert dn == n
    valid = ds[5:5 + n]
    assert valid.min() == 0 and valid.max() == (n - 1) // 1000


def test_capacity_overflow_drops_as_jax():
    """More kept words than the capacity: the overflow is dropped, as the
    JAX package's `.at[idx].set(mode="drop")` drops it."""
    rng = np.random.default_rng(5)
    encoded = _corpus(rng, 3_000, 60)
    counts = np.bincount(encoded, minlength=60).astype(np.int64)
    counts[0] = 0
    kp = subsample_keep_probs(counts, 0.0, int(counts.sum()))
    uni = rng.random(3_000, dtype=np.float32)
    dt, ds, dn = tdp.build_with_uniforms(1_024, 4, encoded, kp, uni,
                                         device="cpu")
    jt, js, jn = jbuild(1_024, 4, encoded, kp, uni)
    assert int(dn) == int(jn) > 1_024
    np.testing.assert_array_equal(dt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ds.numpy(), np.asarray(js))


def test_builder_with_generator_is_well_formed_and_seeded():
    """The generator-driven builder: kept ids only inside the data range,
    padding around it, non-decreasing sentence ids; the same seed builds
    the same epoch, another seed another."""
    n, v = 2_048, 64
    rng = np.random.default_rng(0)
    encoded = torch.from_numpy(_corpus(rng, n, v))
    counts = np.bincount(encoded.numpy(), minlength=v).astype(np.int64)
    counts[0] = 0
    kp = torch.from_numpy(subsample_keep_probs(
        counts, 1e-3, int(counts.sum())).astype(np.float32))
    build = tdp.make_device_epoch_builder(2_048, 5)
    outs = [build(encoded, kp, torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    t, s, k = (x.numpy() for x in outs[0])
    k = int(k)
    assert 0 < k <= n
    assert (t[5:5 + k] > 0).all()
    assert (t[:5] == -1).all() and (s[:5] == -1).all()
    assert (t[5 + k:] == -1).all() and (s[5 + k:] == -1).all()
    assert (np.diff(s[5:5 + k]) >= 0).all()
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert not torch.equal(outs[0][0], outs[2][0])


def test_epoch_seeds_fold_epoch_and_segment():
    """(seed, epoch) for one segment, (seed, epoch, segment) for several:
    distinct, deterministic, and apart from resume_seed's stream."""
    seeds = {ttrain.epoch_seed(1, e, s) for e in range(3)
             for s in (None, 0, 1)}
    assert len(seeds) == 9
    assert ttrain.epoch_seed(1, 2) == ttrain.epoch_seed(1, 2)
    assert ttrain.epoch_seed(1, 2) != ttrain.resume_seed(1, 2)


def _train(tmp_path, **kw):
    from tests.test_integration import _make_corpus
    corpus = str(tmp_path / "corpus.txt")
    _make_corpus(corpus)
    cfg = Word2BitsConfig(
        train_file=corpus, output_file=str(tmp_path / "vec.bin"),
        bitlevel=1, size=16, window=3, negative=5, iter=2, min_count=2,
        alpha=0.05, sample=1e-3, binary=True, batch_size=64,
        steps_per_chunk=8, debug=0, **kw)
    return cfg, ttrain.train(cfg, device="cpu")


@pytest.mark.parametrize("segment_tokens", [1 << 28, 512])
def test_train_builds_epochs_on_the_device(tmp_path, segment_tokens):
    """-device-epoch 1 trains over one segment and over several (the
    corpus uploaded once as [nseg, seg_len]), and writes readable +-1/3
    vectors; the upload and the builds are timed."""
    from word2bits_tpu_torch.io.vectors import read_vectors
    cfg, res = _train(tmp_path, device_epoch=True,
                      segment_tokens=segment_tokens)
    assert all(np.isfinite(x) for x in res.epoch_losses)
    assert res.seconds["epoch_build"] > 0
    words, vecs = read_vectors(cfg.output_file)
    assert len(words) > 5 and np.isfinite(vecs).all()
    np.testing.assert_allclose(np.abs(vecs), 1 / 3, rtol=1e-5)


def test_device_corpus_segments_cover_the_corpus(tmp_path):
    """DeviceCorpus cuts the corpus into [nseg, seg_len] with the tail
    padded by `</s>`; each segment's source length is its share, and the
    same epoch builds the same arrays twice (a resumed run subsamples as
    the first did)."""
    from word2bits_tpu_torch.data.vocab import Vocab
    rng = np.random.default_rng(2)
    enc = _corpus(rng, 1_000, 30)
    counts = np.bincount(enc, minlength=30).astype(np.int64)
    vocab = Vocab(words=[f"w{i}" for i in range(30)], counts=counts)
    cfg = Word2BitsConfig(window=3, batch_size=32, steps_per_chunk=4)
    dc = ttrain.DeviceCorpus(cfg, vocab, enc, 300, 1_024, "cpu")
    assert (dc.nseg, dc.seg_len, dc.pad) == (4, 300, 200)
    assert torch.equal(dc.encoded.reshape(-1)[:1_000],
                       torch.from_numpy(enc))
    assert int(dc.encoded.reshape(-1)[1_000:].abs().sum()) == 0
    a, b = list(dc.segments(1)), list(dc.segments(1))
    assert [x[3] for x in a] == [300, 300, 300, 100]
    for x, y in zip(a, b):
        assert torch.equal(x[0], y[0]) and x[2] == y[2]
    assert not torch.equal(a[0][0], list(dc.segments(2))[0][0])


@pytest.mark.parametrize("device_epoch,cold", [(None, False), (False, True)])
def test_no_cold_map_under_the_device_epoch(tmp_path, device_epoch, cold):
    """-hot-rows -neg-dense-hot 1 under the auto -device-epoch builds its
    epochs on the device and no cold map (the step keeps the plain slab
    scatter, as in the JAX package); with -device-epoch 0 the host build
    and its cold map come back."""
    cfg, res = _train(tmp_path, fused_tables=True, neg_sharing=8,
                      hot_rows=6, neg_dense_hot=True,
                      device_epoch=device_epoch)
    assert cfg.device_epoch_on == (not cold)
    assert (res.seconds["cold_map"] > 0) == cold
    assert all(np.isfinite(x) for x in res.epoch_losses)
