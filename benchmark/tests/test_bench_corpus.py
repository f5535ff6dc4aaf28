"""The generators repeat by seed and hold the stated shapes; the
words-consumed accounting."""

import numpy as np
import torch

from benchmark import accounting
from benchmark.cells import load_cell
from benchmark.corpus import make_corpus, word_names, zipf_counts


def test_same_seed_same_corpus_other_seed_other_order():
    spec = {"n_types": 2000, "head": 20000, "s": 1.05, "min_count": 5,
            "sentence": 20}
    a = make_corpus(spec, 2 ** 31 + 3, "cpu")
    b = make_corpus(spec, 2 ** 31 + 3, "cpu")
    c = make_corpus(spec, 2 ** 31 + 4, "cpu")
    assert np.array_equal(a.encoded, b.encoded)
    assert not np.array_equal(a.encoded, c.encoded)
    assert np.array_equal(a.counts, c.counts)
    # each word exactly its count, `</s>` after every 20 words
    assert np.array_equal(np.bincount(a.encoded, minlength=2000), a.counts)
    assert (a.encoded[20::21] == 0).all()
    assert torch.equal(a.encoded_dev, torch.from_numpy(a.encoded))


def test_one_line_corpus_has_no_sentence_token():
    spec = {"n_types": 500, "head": 5000, "s": 1.05, "min_count": 5,
            "sentence": 0}
    a = make_corpus(spec, 1, "cpu")
    assert a.counts[0] == 0 and (a.encoded > 0).all()
    assert a.train_words == a.encoded.size


def test_capacity_shape():
    cell = load_cell("wiki.capacity-grmw")
    sp = cell.config["corpus"]
    counts = zipf_counts(sp["n_types"], sp["head"], sp["s"], sp["min_count"])
    assert sp["n_types"] == 3_699_941 == counts.size + 1
    assert counts.min() >= 5
    words = int(counts.sum())
    assert words + words // 20 == cell.config["train_tokens"]


def test_text8_shape():
    cell = load_cell("text8.shipped-span")
    sp = cell.config["corpus"]
    counts = zipf_counts(sp["n_types"], sp["head"], sp["s"], sp["min_count"])
    # text8 at min-count 5: 71,290 words and `</s>`, 16,718,844 words in
    # train file, 'the' counted 1,061,396 times
    assert sp["n_types"] == 71_291 == counts.size + 1
    assert counts.min() >= 5 and sp["sentence"] == 0
    assert counts[0] == 1_061_396 == cell.config["source_values"]["top_count"]
    assert int(counts.sum()) == cell.config["train_tokens"] == 16_718_844
    assert cell.config["vocab_words"] == counts.size
    assert len(word_names(sp["n_types"])) == 71_291


def test_words_consumed():
    assert accounting.words_consumed([3, 10, 7], 4) == 80
