"""The port's native tokenizer (native/, built with g++ at first use) on
the CPU.

Counts, encodings (OOV dropped, long words truncated as the reference
does), alias tables and LCG fills from the C++ library are identical to
the port's pure-Python paths and to the JAX package's native paths, as
tests/test_native.py holds the JAX package's; `use_native=True` raises
where the library cannot be built, and the default falls back to Python.
"""

import numpy as np
import pytest
import torch

from word2bits_tpu import native as jnative
from word2bits_tpu.data import corpus as jcorpus
from word2bits_tpu_torch import native
from word2bits_tpu_torch.data import corpus as tcorpus
from word2bits_tpu_torch.sampling.unigram import build_alias_table
from word2bits_tpu_torch.utils.lcg import lcg_uniform_block, \
    lcg_values_scalar

pytestmark = pytest.mark.skipif(
    native.library() is None,
    reason="g++ could not build the native tokenizer here")

CORPUS = (b"alpha beta gamma alpha\nbeta beta\r\n"
          b"  gamma\talpha  \n\ndelta epsilon zeta trailing")


def _file(tmp_path, data: bytes) -> str:
    p = tmp_path / "c.txt"
    p.write_bytes(data)
    return str(p)


def _counts_all_ways(path):
    """Port native, port Python, JAX Python (and JAX native when built)."""
    out = [tcorpus.count_words(path, use_native=True),
           tcorpus.count_words(path, use_native=False),
           jcorpus.count_words(path, use_native=False)]
    if jnative.lib is not None:
        out.append(jcorpus.count_words(path, use_native=True))
    return out


@pytest.mark.parametrize("data", [
    CORPUS,
    b"a" * 4999 + b"z next ",                       # truncated to 4094
    b"b" * 4094 + b" " + b"c" * 4094 + b"z" + b" ",  # the boundary
    b"",
    b"no trailing separator",
])
def test_counts_identical(tmp_path, data):
    got = _counts_all_ways(_file(tmp_path, data))
    assert all(g == got[0] for g in got[1:])


def test_long_word_truncation(tmp_path):
    counts = tcorpus.count_words(_file(tmp_path, b"a" * 4999 + b"z next "),
                                 use_native=True)
    assert [k for k in counts if len(k) > 4000] == ["a" * 4094]


@pytest.mark.parametrize("min_count", [1, 2])
def test_encodings_identical(tmp_path, min_count):
    path = _file(tmp_path, CORPUS)
    vocab = tcorpus.build_vocab(path, min_count=min_count, use_native=False)
    nat = tcorpus.encode_corpus(path, vocab, use_native=True)
    py = tcorpus.encode_corpus(path, vocab, use_native=False)
    jv = jcorpus.build_vocab(path, min_count=min_count, use_native=False)
    assert jv.words == vocab.words
    jpy = jcorpus.encode_corpus(path, jv, use_native=False)
    assert nat.dtype == py.dtype == np.int32
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(nat, jpy)
    assert nat.max() < vocab.size


def test_large_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(500)]
    toks = rng.choice(words, size=200_000)
    path = _file(tmp_path, (" ".join(toks) + "\n" + " ".join(toks[:99])
                            + " ").encode())
    got = _counts_all_ways(path)
    assert all(g == got[0] for g in got[1:])
    vocab = tcorpus.build_vocab(path, min_count=1, use_native=True)
    np.testing.assert_array_equal(
        tcorpus.encode_corpus(path, vocab, use_native=True),
        tcorpus.encode_corpus(path, vocab, use_native=False))


@pytest.mark.parametrize("V", [1, 7, 1000, 40_000])
def test_alias_tables_identical(V):
    from word2bits_tpu.sampling.unigram import build_alias_table as jalias
    w = np.random.default_rng(V).random(V) ** 3 + 1e-6
    nat = build_alias_table(w, use_native=True)
    py = build_alias_table(w, use_native=False)
    assert torch.equal(nat.prob, py.prob) and torch.equal(nat.alias,
                                                          py.alias)
    j = jalias(w)     # the JAX package's (native when its library built)
    np.testing.assert_array_equal(nat.prob.numpy(), np.asarray(j.prob))
    np.testing.assert_array_equal(nat.alias.numpy(),
                                  np.asarray(j.alias).astype(np.int64))


@pytest.mark.parametrize("start,n,seed", [(0, 1000, 1), (12_345, 300_000, 1),
                                          (7, 70_000, 3)])
def test_lcg_fills_identical(start, n, seed):
    from word2bits_tpu.utils.lcg import lcg_uniform_block as jlcg
    nat = lcg_uniform_block(start, n, seed, use_native=True)
    py = lcg_uniform_block(start, n, seed, use_native=False)
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(nat, jlcg(start, n, seed))
    if start == 0:
        np.testing.assert_array_equal(nat, lcg_values_scalar(n, seed))


def test_use_native_true_raises_when_the_build_fails(tmp_path, monkeypatch):
    """A source that does not compile: use_native=True raises with the
    compiler's message at every caller; the default falls back to the
    Python path and gives its results."""
    bad = tmp_path / "tokenizer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed"):
        native.load()
    assert native.library() is None
    path = _file(tmp_path, CORPUS)
    vocab = tcorpus.build_vocab(path, min_count=1, use_native=False)
    w = np.arange(1.0, 50.0)
    for call in (lambda u: tcorpus.count_words(path, use_native=u),
                 lambda u: tcorpus.encode_corpus(path, vocab, use_native=u),
                 lambda u: build_alias_table(w, use_native=u),
                 lambda u: lcg_uniform_block(0, 100, use_native=u)):
        with pytest.raises(RuntimeError, match="native"):
            call(True)
        fallback, python = call(None), call(False)
        if isinstance(python, np.ndarray):
            np.testing.assert_array_equal(fallback, python)
        elif isinstance(python, dict):
            assert fallback == python
        else:
            assert torch.equal(fallback.prob, python.prob)


def test_build_lands_in_the_build_directory():
    """The library is built into _build/ under a name that carries the
    hash of the source and flags; a fresh build replaces it in place."""
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith(
        "libw2btok-") and path.suffix == ".so"
    assert native.build(fresh=True) == path and path.exists()
