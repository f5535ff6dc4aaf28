"""fastText's subword rows in the port (data/vocab.subword_rows, fnv1a):
the hash on hand-computed values, the CSR of `</s>`, repeated n-grams,
`<word>` whole, and the vectorised builder against a per-word loop (the
plain reference, tests/plain_fasttext.py)."""

import pytest
import torch

from tests import plain_fasttext as pf
from word2bits_tpu_torch.data.vocab import (FNV_OFFSET, _fnv_step,
                                            subword_rows)

OFFSET, PRIME = 2166136261, 16777619


def fnv1a(data: bytes) -> int:
    """The port's hash arithmetic (subword_rows' _fnv_step), one string."""
    h = torch.tensor(FNV_OFFSET)
    for b in data:
        h = _fnv_step(h, torch.tensor(b))
    return int(h)


@pytest.mark.parametrize("data,want", [
    (b"", OFFSET),
    # FNV-1a of "a": (2166136261 ^ 0x61) * 16777619 mod 2^32
    (b"a", 0xE40C292C),
    # "<ab": three rounds by hand
    (b"<ab", (((((OFFSET ^ 0x3C) * PRIME % 2**32) ^ 0x61) * PRIME % 2**32
               ^ 0x62) * PRIME) % 2**32),
    # a byte >= 0x80 is sign-extended (int8 -128 -> 0xFFFFFF80) before
    # the xor: 83079839, where an unsigned byte would give 2232128415
    (b"\x80", 83079839),
    ("é".encode(), (((OFFSET ^ 0xFFFFFFC3) * PRIME % 2**32
                     ^ 0xFFFFFFA9) * PRIME) % 2**32),
])
def test_fnv1a_by_hand(data, want):
    assert fnv1a(data) == want == pf.fnv1a(data)


def test_fnv1a_sign_extension_differs_from_unsigned():
    unsigned = ((OFFSET ^ 0x80) * PRIME) % 2**32
    assert unsigned == 2232128415 != fnv1a(b"\x80")


def _group(sub, i):
    return sub.ids[sub.offsets[i]:sub.offsets[i + 1]].tolist()


def test_end_of_sentence_has_its_own_row_only():
    words = ["</s>", "the", "</s>x"]
    sub = subword_rows(words, 3, 6, 1000)
    assert _group(sub, 0) == [0]
    assert len(_group(sub, 2)) > 1           # only `</s>` itself is kept
    assert sub.rows == 3 + 1000


def test_a_repeated_ngram_is_kept_twice():
    # <aaaa>: 'aaa' starts at 1 and 2; 'aaaa' once; 3-grams <aa, aa>
    words = ["</s>", "aaaa"]
    V, nb = 2, 1 << 20
    sub = subword_rows(words, 3, 6, nb)
    g = _group(sub, 1)
    aaa = V + fnv1a(b"aaa") % nb
    assert g.count(aaa) == 2
    assert g == pf.subwords("aaaa", 1, V, 3, 6, nb)
    # by start, then by length: <aa <aaa <aaaa <aaaa> aaa aaaa aaaa> ...
    order = [b"<aa", b"<aaa", b"<aaaa", b"<aaaa>", b"aaa", b"aaaa",
             b"aaaa>", b"aaa", b"aaa>", b"aa>"]
    assert g == [1] + [V + fnv1a(x) % nb for x in order]


@pytest.mark.parametrize("word,whole", [("ab", True), ("abcd", True),
                                        ("abcde", False)])
def test_the_whole_word_is_an_ngram_up_to_maxn_bytes(word, whole):
    nb = 1 << 20
    sub = subword_rows(["</s>", word], 3, 6, nb)
    key = 2 + fnv1a(("<" + word + ">").encode()) % nb
    assert (key in _group(sub, 1)) == whole


def test_maxn_zero_keeps_the_words_own_rows():
    sub = subword_rows(["</s>", "abc", "de"], 3, 0, 100)
    assert sub.ids.tolist() == [0, 1, 2] and sub.rows == 3
    assert sub.max_len == 1


def _spelled(n):
    syl = ("ka", "ri", "to", "ne", "su", "mo", "la", "pe", "é", "x")
    out = ["</s>"]
    for i in range(1, n):
        d = []
        while i:
            i, r = divmod(i - 1, len(syl))
            d.append(syl[r])
        out.append("".join(reversed(d)))
    return out


@pytest.mark.parametrize("minn,maxn,nb", [(3, 6, 2_000_000), (2, 4, 97),
                                          (1, 3, 10)])
def test_vectorised_builder_equals_the_per_word_loop(minn, maxn, nb):
    words = _spelled(200)
    sub = subword_rows(words, minn, maxn, nb)
    ref = pf.bind(words, minn, maxn, nb, "cpu", bitlevel=1, size=4,
                  window=1, negative=1, batch=1)
    assert torch.equal(sub.offsets, ref.offsets)
    assert torch.equal(sub.ids.long(), ref.ids)
    assert sub.ids.dtype == torch.int32
    assert sub.max_len == int((ref.offsets[1:] - ref.offsets[:-1]).max())
    assert int(sub.ids.max()) < sub.rows == 200 + nb


def test_a_word_with_a_newline_is_refused():
    with pytest.raises(ValueError, match="newline"):
        subword_rows(["</s>", "a\nb"], 3, 6, 10)
