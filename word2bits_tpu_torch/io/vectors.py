"""Reference-compatible vector serialization (numpy, host side).

Format (reference src/word2bits.cpp:544-556,561-576):
  header line:  "<vocab_size> <size>\\n"   (ASCII decimal)
  per row:      "<word> "  then `size` values, then "\\n"
    binary=1:   raw little-endian float32
    binary=0:   printf "%lf " per value (6 decimals, trailing space)

The written vector for word i is quantize(u[i] + v[i], bitlevel)
(reference src/word2bits.cpp:548-552), built on the training device
(train.write_output).  With `-model fasttext` it is instead the mean of
the word's subword rows G_w (its own input row and its n-grams' bucket
rows), each quantized as the model reads it, float32: the word's hidden
vector h, as fastText's getWordVector computes it (at bitlevel 0 the
same).  Byte-identical to the JAX package's writer, so files
cross-read between the two packages and the reference `compute-accuracy`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _encode_word(w: str) -> bytes:
    return w.encode("utf-8", errors="surrogateescape")


class VectorWriter:
    """Writes the header, then row blocks in order (the training export
    streams the table through this in row blocks)."""

    def __init__(self, path: str, n_rows: int, size: int,
                 binary: bool = False):
        self.binary, self.size, self.rows_left = binary, size, n_rows
        self._f = open(path, "wb")
        self._f.write(f"{n_rows} {size}\n".encode())

    def write_rows(self, words: List[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape != (len(words), self.size):
            raise ValueError(f"{len(words)} words vs rows {vectors.shape}")
        if len(words) > self.rows_left:
            raise ValueError("more rows than the header's count")
        self.rows_left -= len(words)
        if self.binary:
            rows = vectors.astype("<f4", copy=False)
            self._f.write(b"".join(
                _encode_word(w) + b" " + rows[i].tobytes() + b"\n"
                for i, w in enumerate(words)))
        else:
            self._f.write(b"".join(
                _encode_word(w) + b" "
                + "".join(f"{x:f} " for x in vectors[i]).encode() + b"\n"
                for i, w in enumerate(words)))

    def close(self) -> None:
        self._f.close()
        if self.rows_left:
            raise ValueError(f"{self.rows_left} rows were never written")

    def __enter__(self) -> "VectorWriter":
        return self

    def __exit__(self, exc_type, *_) -> None:
        if exc_type is None:
            self.close()
        else:
            self._f.close()


def write_vectors(path: str, words: List[str], vectors: np.ndarray,
                  binary: bool = False) -> None:
    """Write rows exactly as the reference does."""
    vectors = np.asarray(vectors, dtype=np.float32)
    V, D = vectors.shape
    if len(words) != V:
        raise ValueError(f"{len(words)} words vs {V} rows")
    with VectorWriter(path, V, D, binary) as w:
        w.write_rows(words, vectors)


def _open_maybe_gzip(path: str):
    """The reference's pretrained-vector catalog ships gzip'd text files
    (reference README.md:27-41): sniff the magic and decompress."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic != b"\x1f\x8b":
        return f
    import gzip
    import io
    with f:
        return io.BytesIO(gzip.open(f).read())


def read_vectors(path: str, binary: bool | None = None,
                 max_words: int = 0) -> Tuple[List[str], np.ndarray]:
    """Read either format, plain or gzip'd; binary=None sniffs it.
    max_words truncates like the reference evaluator's threshold
    (src/compute-accuracy.c:86)."""
    with _open_maybe_gzip(path) as f:
        header = f.readline().split()
        V, D = int(header[0]), int(header[1])
        if max_words and V > max_words:
            V = max_words
        if binary is None:
            pos = f.tell()
            probe = f.read(4096)
            f.seek(pos)
            # text rows are printable ASCII; binary rows are raw fp32 bytes
            sample = probe.split(b" ", 1)[-1][:64]
            binary = any(b > 0x7E or (b < 0x20 and b not in (0x0A, 0x0D))
                         for b in sample)
        words: List[str] = []
        out = np.empty((V, D), dtype=np.float32)
        if binary:
            data = f.read()
            pos = 0
            row_bytes = 4 * D
            for i in range(V):
                while pos < len(data) and data[pos] == 0x0A:  # row breaks
                    pos += 1
                sp = data.index(b" ", pos)
                words.append(data[pos:sp].decode("utf-8",
                                                 errors="surrogateescape"))
                pos = sp + 1
                out[i] = np.frombuffer(data, dtype="<f4", count=D, offset=pos)
                pos += row_bytes
        else:
            for i in range(V):
                parts = f.readline().split()
                words.append(parts[0].decode("utf-8", errors="surrogateescape"))
                out[i] = np.asarray(parts[1:D + 1], dtype=np.float32)
    return words, out


def output_vectors(u: np.ndarray, v: np.ndarray, bitlevel: int) -> np.ndarray:
    """The exported representation quantize(u + v, bitlevel) of host arrays
    (reference src/word2bits.cpp:548-550), in numpy.  Training exports on
    the tables' device in row blocks instead (train.write_output)."""
    from word2bits_tpu_torch.ops.quantize import quantize_np

    s = np.asarray(u, np.float32) + np.asarray(v, np.float32)
    return np.asarray(quantize_np(s, bitlevel), np.float32)
