"""The port's capacity path == the JAX package's (CPU): the grmw training
chunk against the JAX chunk under every loop mode (the port's one loop
takes none), the fused table's row-block init, and the row-block export
of vectors and `.pack` files.

The grmw chunk runs the JAX make_fused_train_chunk (group-RMW kernel and
context kernel in interpret mode, table padded to its 8-row float32
groups) and the port's chunk on the same table, with the window shrinks
and negatives the JAX chunk draws from its key handed to the port's chunk.
Tolerances follow tests/test_torch_fused.py: table atol/rtol 1e-4, loss
rtol 1e-5.  Init and export are exact: bit for bit and byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.io import packed as jpacked
from word2bits_tpu.io import vectors as jvec
from word2bits_tpu.models.cbow import CBOWHyper as JHyper
from word2bits_tpu.models.cbow import ChunkScalars as JScalars
from word2bits_tpu.models.cbow_fused import make_fused_train_chunk as jchunk
from word2bits_tpu.models.init import init_params as jinit
from word2bits_tpu.sampling.unigram import build_alias_table as jalias
from word2bits_tpu.sampling.unigram import draw_negatives as jdraw
from word2bits_tpu.utils import lcg as jlcg
from word2bits_tpu_torch import train as ttrain
from word2bits_tpu_torch.config import config_from_argv
from word2bits_tpu_torch.data.vocab import Vocab
from word2bits_tpu_torch.io import packed as tpacked
from word2bits_tpu_torch.models import cbow_fused as tf
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.models.init import init_fused_table, init_params
from word2bits_tpu_torch.sampling.unigram import build_alias_table
from word2bits_tpu_torch.utils import lcg as tlcg

V, D, B, W, K, G, P, S = 500, 64, 256, 3, 5, 16, 2, 3
BANDED = 64


@pytest.mark.parametrize("loop_mode", ["scan", "fori", "unroll"])
def test_grmw_chunk_matches_jax_chunk(rng, loop_mode):
    hyper_kw = dict(bitlevel=1, size=D, window=W, negative=K, reg=0.0)
    n = S * B + 2 * W + 40
    tokens = rng.integers(0, V, n).astype(np.int32)
    tokens[:W] = -1
    sents = (np.arange(n) // 37).astype(np.int32)
    sents[:W] = -1
    table = rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(np.float32)
    weights = np.arange(V, 0, -1, dtype=np.float64) ** 0.75
    atab = jalias(weights)
    sc = dict(base0=W, alpha0=0.05, wca_start=1000.0,
              wca_per_step=float(B) * 1.3, denom=3e4)
    key = jax.random.PRNGKey(11)

    vpad = (-V) % 8                      # the float32 group tile
    fn = jchunk(JHyper(**hyper_kw), V, B, S, neg_sharing=G, neg_pool=P,
                donate=False, banded=BANDED, scatter_impl="grmw",
                loop_mode=loop_mode, context_pallas=True)
    want, wloss = fn(jnp.pad(jnp.asarray(table), ((0, vpad), (0, 0))),
                     jnp.asarray(tokens), jnp.asarray(sents), atab.prob,
                     atab.alias,
                     JScalars(base0=jnp.int32(sc["base0"]),
                              **{k: jnp.float32(v) for k, v in sc.items()
                                 if k != "base0"}), key)
    want = np.asarray(want)
    assert not want[V:].any()

    # the JAX chunk's own draws: per step (k_neg, k_win) = split(key_s)
    shrinks, negs = [], []
    for k in jax.random.split(key, S):
        k_neg, k_win = jax.random.split(k)
        shrinks.append(np.asarray(jax.random.randint(k_win, (B,), 0, W,
                                                     dtype=jnp.int32)))
        negs.append(np.asarray(jdraw(k_neg, atab, (B // G, P * K), V)))
    port = tf.make_fused_train_chunk(CBOWHyper(**hyper_kw), V, B, S,
                                     neg_sharing=G, neg_pool=P,
                                     banded=BANDED, scatter_impl="grmw",
                                     context_pallas=True)
    got = tf.params_from_jax(np.pad(table, ((0, vpad), (0, 0))),
                             dtype=torch.float32, device="cpu",
                             table_pad=(vpad, 0))
    got, loss = port(got, torch.from_numpy(tokens).long(),
                     torch.from_numpy(sents).long(),
                     build_alias_table(weights), ChunkScalars(**sc),
                     shrinks=torch.from_numpy(np.stack(shrinks)).long(),
                     negs=torch.from_numpy(np.stack(negs)).long())
    np.testing.assert_allclose(got.numpy(), want[:V], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5,
                               atol=1e-3)


def test_loop_mode_rejects_unknown():
    with pytest.raises(ValueError, match="-loop-mode 'while'"):
        config_from_argv(["-fused-tables", "1", "-neg-sharing", str(G),
                          "-loop-mode", "while"])


@pytest.mark.parametrize("start,n", [(0, 1), (12345, 200_000),
                                     (5_000_000_000, 70_000)])
def test_lcg_torch_matches_numpy_bits(start, n):
    want = tlcg.lcg_uniform_block(start, n)
    got = tlcg.lcg_uniform_torch(start, n, "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        got.view(np.uint32), jlcg.lcg_uniform_block(start, n).view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_fused_table_bit_equal(monkeypatch, dtype):
    """Row blocks of a few draws each (the block size is cut to make many
    blocks and ragged edges) give init_params' table, and the JAX
    package's, bit for bit."""
    import word2bits_tpu_torch.models.init as tinit
    monkeypatch.setattr(tinit, "_BLOCK", 7 * 24)
    Vs, Ds = 1001, 24
    got = init_fused_table(Vs, Ds, dtype=getattr(torch, dtype),
                           device="cpu")
    u, v = init_params(Vs, Ds, dtype=getattr(torch, dtype), device="cpu")
    assert torch.equal(got, torch.cat([u, v], dim=1))
    ju, jv = jinit(Vs, Ds, init="reference", dtype=jnp.dtype(dtype))
    want = np.concatenate([np.asarray(ju), np.asarray(jv)], axis=1)
    np.testing.assert_array_equal(got.view(torch.int16 if dtype ==
                                           "bfloat16" else torch.int32)
                                  .numpy(),
                                  want.view(np.int16 if dtype == "bfloat16"
                                            else np.int32))


def _vocab(n):
    words = ["</s>"] + [f"w{i}" for i in range(n - 2)] + ["na\xefve"]
    return Vocab(words=words, counts=np.arange(n, 0, -1, dtype=np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bitlevel,binary", [(1, True), (1, False),
                                             (2, True), (0, True),
                                             (4, False)])
def test_export_matches_jax_bytes(tmp_path, monkeypatch, rng, dtype,
                                  bitlevel, binary):
    """write_output in row blocks (cut to 5 rows here) == the JAX
    package's output_vectors + write_vectors (+ write_packed with
    -packed 1 at bitlevel 1 or 2), byte for byte."""
    monkeypatch.setattr(ttrain, "_EXPORT_VALUES", 5 * 12)
    Vs, Ds = 37, 12
    vocab = _vocab(Vs)
    table = torch.from_numpy(rng.normal(scale=0.4, size=(Vs, 2 * Ds))
                             .astype(np.float32)).to(getattr(torch, dtype))
    cfg = config_from_argv(["-bitlevel", str(bitlevel), "-binary",
                            str(int(binary)), "-packed", "1"])
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    ttrain.write_output(tp, vocab, (table,), cfg)
    u, v = tf.deinterleave(tf.params_to_numpy(table))
    vecs = jvec.output_vectors(u, v, bitlevel)
    jvec.write_vectors(jp, vocab.words, vecs, binary=binary)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    if bitlevel in (1, 2):
        jpacked.write_packed(jp + ".pack", vocab.words, vecs, bitlevel)
        assert (open(tp + ".pack", "rb").read()
                == open(jp + ".pack", "rb").read())
    else:
        assert not (tmp_path / "t.bin.pack").exists()


@pytest.mark.parametrize("bitlevel,D_", [(1, 12), (2, 13), (1, 800)])
def test_packed_roundtrip_and_cross_read(tmp_path, rng, bitlevel, D_):
    Vs = 23
    words = _vocab(Vs).words
    x = rng.normal(size=(Vs, D_)).astype(np.float32)
    q = (np.where(x < 0, -1, 1) * (np.float32(1) / np.float32(3))
         if bitlevel == 1 else
         np.where(x < 0, -1, 1) * np.where(np.abs(x) <= 0.5, 0.25, 0.75)
         ).astype(np.float32)
    tp, jp = str(tmp_path / "t.pack"), str(tmp_path / "j.pack")
    tpacked.write_packed(tp, words, q, bitlevel)
    jpacked.write_packed(jp, words, q, bitlevel)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    # the payload alone: the JAX file's bytes after the word list
    payload = tpacked.pack_codes(torch.from_numpy(q), bitlevel).numpy()
    assert open(jp, "rb").read().endswith(payload.tobytes())
    w, got, bl = tpacked.read_packed(jp)
    assert (w, bl) == (words, bitlevel)
    np.testing.assert_array_equal(got, q)
    np.testing.assert_array_equal(jpacked.read_packed(tp)[1], q)
    w, part, _ = tpacked.read_packed(tp, max_words=5, first_row=7)
    assert w == words[7:12]
    np.testing.assert_array_equal(part, q[7:12])
    assert tpacked.read_packed(tp, max_words=1000)[1].shape == (Vs, D_)


def test_packed_rejects_off_grid(tmp_path):
    with pytest.raises(ValueError, match="grid"):
        tpacked.write_packed(str(tmp_path / "x.pack"), ["a"],
                             np.full((1, 4), 0.3, np.float32), 1)
    with pytest.raises(ValueError, match="bitlevel"):
        tpacked.pack_codes(torch.zeros(2, 4), 4)


def test_zipf_vocab_corpus_counts_match_the_corpus():
    """The in-memory capacity-shaped vocabulary: every count >= min-count,
    descending after `</s>`, and the encoded corpus holds each word exactly
    its count, with a break every `sentence` words."""
    from word2bits_tpu_torch.data.synthetic import zipf_vocab_corpus
    vocab, enc = zipf_vocab_corpus(2000, head=500.0, sentence=7, seed=3)
    assert vocab.size == 2000 and vocab.words[0] == "</s>"
    np.testing.assert_array_equal(np.bincount(enc, minlength=vocab.size),
                                  vocab.counts)
    assert vocab.counts[1:].min() == 5
    assert np.all(np.diff(vocab.counts[1:]) <= 0)
    assert np.all(enc[7::8] == 0) and vocab.train_words == enc.size
