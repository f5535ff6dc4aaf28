"""Reference-compatible vector serialization (numpy, host side).

Format (reference src/word2bits.cpp:544-556,561-576):
  header line:  "<vocab_size> <size>\\n"   (ASCII decimal)
  per row:      "<word> "  then `size` values, then "\\n"
    binary=1:   raw little-endian float32
    binary=0:   printf "%lf " per value (6 decimals, trailing space)

The written vector for word i is quantize(u[i] + v[i], bitlevel)
(reference src/word2bits.cpp:548-552).  Byte-identical to the JAX
package's writer, so files cross-read between the two packages and the
reference `compute-accuracy`.
"""

from __future__ import annotations

import io as _io
from typing import List, Tuple

import numpy as np


def _encode_word(w: str) -> bytes:
    return w.encode("utf-8", errors="surrogateescape")


def write_vectors(path: str, words: List[str], vectors: np.ndarray,
                  binary: bool = False) -> None:
    """Write rows exactly as the reference does."""
    vectors = np.asarray(vectors, dtype=np.float32)
    V, D = vectors.shape
    if len(words) != V:
        raise ValueError(f"{len(words)} words vs {V} rows")
    buf = _io.BytesIO()
    buf.write(f"{V} {D}\n".encode())
    if binary:
        rows = vectors.astype("<f4", copy=False)
        for i, w in enumerate(words):
            buf.write(_encode_word(w) + b" ")
            buf.write(rows[i].tobytes())
            buf.write(b"\n")
    else:
        for i, w in enumerate(words):
            vals = "".join(f"{x:f} " for x in vectors[i])
            buf.write(_encode_word(w) + b" " + vals.encode() + b"\n")
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def read_vectors(path: str, binary: bool | None = None
                 ) -> Tuple[List[str], np.ndarray]:
    """Read either format; binary=None sniffs it."""
    with open(path, "rb") as f:
        header = f.readline().split()
        V, D = int(header[0]), int(header[1])
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
    """The exported representation: quantize(u + v, bitlevel), computed
    host-side in float32 (reference src/word2bits.cpp:548-550)."""
    from word2bits_tpu_torch.ops.quantize import quantize_np

    s = np.asarray(u, np.float32) + np.asarray(v, np.float32)
    return np.asarray(quantize_np(s, bitlevel), np.float32)
