"""The port's host-side modules == the JAX package's (CPU).

Alias table, LCG init (float32 and its bfloat16 cast), vocabulary, corpus
encoding, epoch arrays and the synthetic corpus are bit-equal; the vector
writer is byte-equal and each package reads the other's files.  Negative
draws come from another generator, so they are held to the distribution
(chi-square, as tests/test_sampling.py) instead of to JAX's bits.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.data import corpus as jcorpus
from word2bits_tpu.data import pipeline as jpipe
from word2bits_tpu.data import synthetic as jsyn
from word2bits_tpu.data.vocab import Vocab as JVocab
from word2bits_tpu.io import vectors as jvec
from word2bits_tpu.models.init import init_params as jinit
from word2bits_tpu.sampling.unigram import build_alias_table as jalias
from word2bits_tpu.utils import lcg as jlcg
from word2bits_tpu_torch.data import corpus as tcorpus
from word2bits_tpu_torch.data import pipeline as tpipe
from word2bits_tpu_torch.data import synthetic as tsyn
from word2bits_tpu_torch.data import vocab as tvocab
from word2bits_tpu_torch.io import vectors as tvec
from word2bits_tpu_torch.ops import quantize as tquant
from word2bits_tpu_torch.models.init import init_params as tinit
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  draw_negatives)
from word2bits_tpu_torch.utils import lcg as tlcg

# the JAX package's ops/__init__ re-exports a function named `quantize`
jquant = importlib.import_module("word2bits_tpu.ops.quantize")


def _zipf_weights(rng, V=500):
    counts = np.sort(rng.zipf(1.3, 20 * V))[::-1][:V].astype(np.float64)
    return counts ** 0.75


@pytest.mark.parametrize("V", [1, 7, 500])
def test_alias_table_bit_equal(rng, V):
    w = _zipf_weights(rng, V)
    want = jalias(w)
    got = build_alias_table(w)
    np.testing.assert_array_equal(got.prob.numpy().view(np.uint32),
                                  np.asarray(want.prob).view(np.uint32))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))


def test_draw_negatives_distribution():
    """count^0.75 frequencies, id 0 remapped uniformly to [1, V-1]."""
    counts = np.asarray([0, 1000, 100, 10, 1, 500], dtype=np.float64)
    weights = counts ** 0.75
    table = build_alias_table(weights)
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    draws = draw_negatives(gen, table, (n,), len(counts)).numpy()
    assert (draws == 0).sum() == 0
    assert draws.min() >= 1 and draws.max() < len(counts)
    got = np.bincount(draws, minlength=len(counts)).astype(np.float64)
    p = weights / weights.sum()
    expect = p * n
    expect[1:] += expect[0] / (len(counts) - 1)
    expect[0] = 0
    mask = expect > 5
    chi2 = np.sum((got[mask] - expect[mask]) ** 2 / expect[mask])
    assert chi2 < (mask.sum() - 1) * 8, (chi2, got, expect)


def test_draw_negatives_shape_and_zero_remap():
    # all the mass on `</s>`: every draw is remapped into [1, V-1]
    table = build_alias_table(np.asarray([1.0, 0.0, 0.0, 0.0]))
    d = draw_negatives(torch.Generator().manual_seed(1), table, (64, 8), 4)
    assert d.shape == (64, 8)
    assert d.min() >= 1 and d.max() <= 3
    assert len(torch.unique(d)) == 3


def test_lcg_blocks_bit_equal():
    for start, n in [(0, 1000), (12345, 70000), (3 * (1 << 16) + 5, 17)]:
        np.testing.assert_array_equal(tlcg.lcg_uniform_block(start, n),
                                      jlcg.lcg_uniform_block(start, n))
    np.testing.assert_array_equal(tlcg.lcg_uniform_block(0, 300),
                                  tlcg.lcg_values_scalar(300))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_init_bit_equal(dtype):
    V, D = 301, 24
    ju, jv = jinit(V, D, init="reference", dtype=jnp.dtype(dtype),
                   as_numpy=True)
    tu, tv = tinit(V, D, init="reference", dtype=getattr(torch, dtype),
                   device="cpu")
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    ibits = torch.int16 if dtype == "bfloat16" else torch.int32
    for t, j in ((tu, ju), (tv, jv)):
        assert t.dtype == getattr(torch, dtype) and t.shape == (V, D)
        np.testing.assert_array_equal(t.view(ibits).numpy().view(bits),
                                      np.asarray(j).view(bits))


def test_uniform_init_range():
    u, v = tinit(50, 8, init="uniform", seed=3, device="cpu")
    assert u.shape == v.shape == (50, 8)
    assert float(u.abs().max()) <= 0.5 and not torch.equal(u, v)
    with pytest.raises(ValueError, match="init"):
        tinit(5, 2, init="xavier", device="cpu")


def _write_corpus(path, rng):
    words = [f"w{i}" for i in range(40)] + ["caf\xe9", "x" * 5000]
    lines = []
    for _ in range(300):
        n = int(rng.integers(3, 30))
        lines.append(" ".join(words[int(rng.zipf(1.4)) % len(words)]
                              for _ in range(n)))
    data = ("\r\n".join(lines[:50]) + "\n" + "\n".join(lines[50:])
            + "\n\t double  space\ntrailing")
    with open(path, "wb") as f:
        f.write(data.encode("utf-8"))


def test_tokens_vocab_and_encoding_equal(tmp_path, rng):
    path = str(tmp_path / "c.txt")
    _write_corpus(path, rng)
    data = open(path, "rb").read()
    assert tcorpus.split_tokens(data) == list(jcorpus.tokenize_bytes(data))
    tv = tcorpus.build_vocab(path, min_count=2)
    jv = jcorpus.build_vocab(path, min_count=2, use_native=False)
    assert tv.words == jv.words
    np.testing.assert_array_equal(tv.counts, jv.counts)
    assert tv.train_words == jv.train_words
    np.testing.assert_array_equal(tcorpus.encode_corpus(path, tv),
                                  jcorpus.encode_corpus(path, jv,
                                                        use_native=False))
    np.testing.assert_array_equal(tv.unigram_weights(), jv.unigram_weights())
    # save / load round trip through either package
    tv.save(str(tmp_path / "v.txt"))
    for load in (JVocab.load, tvocab.Vocab.load):
        back = load(str(tmp_path / "v.txt"), min_count=3)
        assert back.words == jv.words[:1] + [w for w, c in zip(
            jv.words[1:], jv.counts[1:]) if c >= 3]


# \r anywhere, tabs, runs of separators, words about the reference's
# MAX_STRING - 1 truncation, vertical tab and form feed (word bytes in the
# reference), a trailing word with no separator
TOKENIZE_CASES = [
    b"a\rb c\r\n d\r\n\r",
    b"\tx\t\ty \t\n\tz\t",
    b"  \n\n \t \n p   q\n\n\t\t",
    b"w" * 5000 + b" " + b"v" * 4095 + b"\t" + b"u" * 4094 + b"\n"
    + b"s" * 4093 + b" " + b"r" * 4200,
    b"one two\nthree",
    b"tail\r",
    b"a\x0bb\x0cc d\n e\x0b",
    b"",
]


@pytest.mark.parametrize("drop_trailing", [True, False])
@pytest.mark.parametrize("case", range(len(TOKENIZE_CASES)))
def test_tokenize_bytes_matches_jax(case, drop_trailing):
    """tokenize_bytes yields the JAX package's stream, and split_tokens
    builds the same list (a trailing word dropped)."""
    data = TOKENIZE_CASES[case]
    got = list(tcorpus.tokenize_bytes(data, drop_trailing=drop_trailing))
    assert got == list(jcorpus.tokenize_bytes(data,
                                              drop_trailing=drop_trailing))
    if drop_trailing:
        assert tcorpus.split_tokens(data) == got


@pytest.mark.parametrize("sample,segment", [(1e-3, 1 << 28), (1e-2, 777),
                                            (0.0, 1 << 28)])
def test_epoch_arrays_equal(rng, sample, segment):
    V = 60
    counts = np.sort(rng.integers(1, 500, V))[::-1].astype(np.int64)
    enc = rng.integers(0, V, 5000).astype(np.int32)
    enc[rng.integers(0, 5000, 40)] = 0      # sentence breaks
    enc[100:2300] = np.maximum(enc[100:2300], 1)   # one sentence > 1000
    tw = int(counts.sum())
    got = list(tpipe.iter_epoch_segments(enc, counts, sample, tw, 4,
                                         np.random.default_rng(7), segment))
    want = list(jpipe.iter_epoch_segments(enc, counts, sample, tw, 4,
                                          np.random.default_rng(7), segment))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.sent_ids, w.sent_ids)
        assert (g.n_tokens, g.halo, g.source_len) == (w.n_tokens, w.halo,
                                                      w.source_len)
    np.testing.assert_array_equal(
        tpipe.subsample_keep_probs(counts, sample, tw),
        jpipe.subsample_keep_probs(counts, sample, tw))


def test_synthetic_corpus_same_bytes(tmp_path):
    tsyn.zipf_corpus(str(tmp_path / "t.txt"), n_tokens=3000, vocab=900,
                     seed=4, chunk=1000)
    jsyn.zipf_corpus(str(tmp_path / "j.txt"), n_tokens=3000, vocab=900,
                     seed=4, chunk=1000)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("bitlevel", [0, 1, 2, 4])
def test_vectors_byte_equal_and_cross_read(tmp_path, rng, binary, bitlevel):
    V, D = 37, 12
    words = ["</s>"] + [f"w{i}" for i in range(V - 2)] + ["na\xefve"]
    u = rng.normal(scale=0.4, size=(V, D)).astype(np.float32)
    v = rng.normal(scale=0.4, size=(V, D)).astype(np.float32)
    tvecs = jvec.output_vectors(u, v, bitlevel)
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tvec.write_vectors(tp, words, tvecs, binary=binary)
    jvec.write_vectors(jp, words, tvecs, binary=binary)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    jw, jr = jvec.read_vectors(tp)             # the JAX reader, port file
    tw, tr = tvec.read_vectors(jp)             # the port reader, JAX file
    assert jw == tw == words
    tol = 0 if binary else 6e-7                # text rows: 6 decimals
    np.testing.assert_allclose(jr, tvecs, atol=tol, rtol=0)
    np.testing.assert_array_equal(tr, jr)
    if bitlevel == 1 and binary:
        assert np.all(np.abs(tr) == np.float32(1) / np.float32(3))


def test_quantize_np_matches_jax_on_vectors(rng):
    x = rng.normal(size=(20, 9)).astype(np.float32)
    np.testing.assert_array_equal(tquant.quantize_np(x + x, 8),
                                  jquant.quantize_np(x + x, 8))
