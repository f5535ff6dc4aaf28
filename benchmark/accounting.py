"""Words consumed: the reference's word_count_actual (reference
src/word2bits.cpp:379-393), as bench.py:8-11 counts it (commit
26809b4dee3683ec1871bc5d1e1a6fa56c4992c9): every corpus word an epoch
reads, kept or discarded by subsampling, and every sentence token.  An
epoch of a corpus therefore consumes the vocabulary's total count,
`</s>` included, whatever subsampling keeps."""


def words_consumed(counts, epochs: int) -> int:
    """Words consumed by `epochs` whole epochs over a corpus whose
    vocabulary counts are `counts` (`</s>` first)."""
    return int(epochs) * int(sum(int(c) for c in counts))
