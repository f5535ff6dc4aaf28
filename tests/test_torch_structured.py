"""The port's copies of the JAX package's pure-host modules and the four
small functions missing from modules ported earlier, on the CPU.

- data/structured.structured_corpus: byte-equal corpus and question files
  for the same seed and sizes;
- data/wikifil: wikifil_text, _filter_record and main equal to the JAX
  package's on tests/test_wikifil.py's inputs (the Perl oracle those tests
  need is not used here);
- ops/scatter.scatter_add_sorted, ops/quantize.quantized_storage_bits,
  io/vectors.output_vectors and data/pipeline.expected_kept_fraction
  against their JAX counterparts (float32 tables: atol 1e-6; the rest
  exact).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_wikifil import ADVERSARIAL, SAMPLE
from word2bits_tpu.data import structured as jstructured
from word2bits_tpu.data import wikifil as jwikifil
from word2bits_tpu_torch.data import structured as tstructured
from word2bits_tpu_torch.data import wikifil as twikifil


@pytest.mark.parametrize("seed,na,nb,n_sentences,n_questions", [
    (0, 20, 20, 2_000, 100),
    (3, 5, 7, 500, 40),
    (11, 20, 20, 300, 1000),      # fewer distinct questions than asked
])
def test_structured_corpus_files_byte_equal(tmp_path, seed, na, nb,
                                            n_sentences, n_questions):
    paths = {}
    for tag, fn in (("jax", jstructured.structured_corpus),
                    ("port", tstructured.structured_corpus)):
        c, q = tmp_path / f"{tag}.txt", tmp_path / f"{tag}_q.txt"
        fn(str(c), str(q), na=na, nb=nb, n_sentences=n_sentences,
           n_questions=n_questions, seed=seed)
        paths[tag] = (c.read_bytes(), q.read_bytes())
    assert paths["port"] == paths["jax"]
    assert paths["port"][1].startswith(b": grid-semantic\n")


@pytest.mark.parametrize("text", [
    SAMPLE,
    ADVERSARIAL,
    ADVERSARIAL.rstrip(">\n"),                   # no trailing '>'
    '<text xml:space="preserve">#REDIRECT [[Other page]]</text>\n',
    "",
])
def test_wikifil_text_equals_jax(text):
    assert twikifil.wikifil_text(text) == jwikifil.wikifil_text(text)


def test_wikifil_records_and_main_equal_jax(tmp_path):
    for rec in ADVERSARIAL.split(">"):
        assert (twikifil._filter_record(rec + ">")
                == jwikifil._filter_record(rec + ">"))
    src = tmp_path / "enwik.xml"
    src.write_text(ADVERSARIAL, encoding="utf-8")
    outs = []
    for mod in (twikifil, jwikifil):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main([str(src)]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "alpha" in outs[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert twikifil.main([]) == 0
    assert "word2bits_tpu_torch.data.wikifil" in buf.getvalue()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_sorted_equals_jax(dtype):
    from word2bits_tpu.ops.scatter import scatter_add_sorted as jsorted
    from word2bits_tpu_torch.ops.scatter import scatter_add_sorted
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, (50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, 300)
    rows = rng.uniform(-0.1, 0.1, (300, 8)).astype(np.float32)
    jt = jnp.asarray(table, jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    want = np.asarray(jsorted(jt, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(rows)).astype(jnp.float32))
    t = torch.from_numpy(table).to(dtype)
    got = scatter_add_sorted(t, torch.from_numpy(ids), torch.from_numpy(rows))
    assert got is t                       # in place
    atol = 1e-6 if dtype == torch.float32 else 2 ** -6 * 6
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               atol=atol)


@pytest.mark.parametrize("bitlevel", [0, 1, 2, 3, 4, 8, 16])
def test_quantized_storage_bits_equals_jax(bitlevel):
    from word2bits_tpu.ops.quantize import quantized_storage_bits as jbits
    from word2bits_tpu_torch.ops.quantize import quantized_storage_bits
    assert quantized_storage_bits(bitlevel) == jbits(bitlevel)


@pytest.mark.parametrize("bitlevel", [0, 1, 2, 4, 8])
def test_output_vectors_equals_jax(bitlevel):
    from word2bits_tpu.io.vectors import output_vectors as jout
    from word2bits_tpu_torch.io.vectors import output_vectors
    rng = np.random.default_rng(bitlevel)
    u = rng.uniform(-1, 1, (40, 12)).astype(np.float32)
    v = rng.uniform(-1, 1, (40, 12)).astype(np.float32)
    got = output_vectors(u, v, bitlevel)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jout(u, v, bitlevel))


@pytest.mark.parametrize("sample,train_words", [(1e-3, 5_000), (0.0, 5_000),
                                                (1e-2, 0), (1e-4, 123)])
def test_expected_kept_fraction_equals_jax(sample, train_words):
    from word2bits_tpu.data.pipeline import expected_kept_fraction as jfrac
    from word2bits_tpu_torch.data.pipeline import expected_kept_fraction
    counts = np.random.default_rng(1).integers(0, 900, 60).astype(np.int64)
    counts[0] = 0
    assert (expected_kept_fraction(counts, sample, train_words)
            == jfrac(counts, sample, train_words))
