"""Packed quantized vector storage (the `-packed 1` output, `.pack`).

The same format as the JAX package's io/packed.py, byte for byte: 1-bit
and 2-bit vectors stored at b bits per dimension (1-bit: sign -> +-1/3;
2-bit: sign+magnitude -> {+-0.25, +-0.75}) plus the word list.

Format (little-endian):
  magic b"W2BPACK1"
  uint32 vocab_size, uint32 size, uint32 bitlevel, uint32 words_bytes
  '\\n'-joined utf-8 word list
  payload: per row, ceil(size*bitlevel/8) bytes (rows independently
  addressable); bit b of dimension d is bit (d*bitlevel + b) of the row,
  least significant bit first within each byte

Rows are independent, so a file is written in row blocks (`PackedWriter`,
with the codes packed on the training device by `pack_codes`) and read in
row blocks (`read_packed(first_row=, max_words=)`).
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

MAGIC = b"W2BPACK1"
_HEADER = struct.Struct("<IIII")


def row_bytes(size: int, bitlevel: int) -> int:
    return (size * bitlevel + 7) // 8


def _check_grid(v: np.ndarray, bitlevel: int) -> None:
    if bitlevel == 1:
        if not np.all(np.abs(np.abs(v) * 3.0 - 1.0) < 1e-5):
            raise ValueError("values not on the 1-bit grid (+-1/3)")
    elif bitlevel == 2:
        a = np.abs(v)
        if not np.all((np.abs(a - 0.25) < 1e-6) | (np.abs(a - 0.75) < 1e-6)):
            raise ValueError("values not on the 2-bit grid (+-0.25/+-0.75)")
    else:
        raise ValueError(f"packed storage supports bitlevel 1 or 2, got "
                         f"{bitlevel}")


def _decode_codes(codes: np.ndarray, bitlevel: int) -> np.ndarray:
    if bitlevel == 1:
        third = np.float32(1.0) / np.float32(3.0)
        return np.where(codes & 1, -third, third).astype(np.float32)
    mag = np.where(codes & 1, np.float32(0.75), np.float32(0.25))
    return np.where((codes >> 1) & 1, -mag, mag).astype(np.float32)


def pack_codes(q: torch.Tensor, bitlevel: int) -> torch.Tensor:
    """uint8 [R, row_bytes] payload of quantized rows q [R, D] (values on
    the bitlevel's grid, as quantize() gives them), on q's device: the code
    of a value is its sign bit (bitlevel 1), or sign bit and |q| > 0.5
    (bitlevel 2).  The grid is not checked here."""
    if bitlevel not in (1, 2):
        raise ValueError(f"packed storage supports bitlevel 1 or 2, got "
                         f"{bitlevel}")
    R, D = q.shape
    codes = torch.signbit(q).to(torch.uint8)
    if bitlevel == 2:
        codes = (codes << 1) | (q.abs() > 0.5).to(torch.uint8)
    shifts = torch.arange(bitlevel, dtype=torch.uint8, device=q.device)
    bits = ((codes[:, :, None] >> shifts) & 1).reshape(R, D * bitlevel)
    nb = row_bytes(D, bitlevel)
    bits = torch.nn.functional.pad(bits, (0, nb * 8 - D * bitlevel))
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                           device=q.device)
    return (bits.reshape(R, nb, 8) * weights).sum(dim=2, dtype=torch.uint8)


class PackedWriter:
    """Writes the header and word list, then payload row blocks in order."""

    def __init__(self, path: str, words: List[str], size: int,
                 bitlevel: int):
        if bitlevel not in (1, 2):
            raise ValueError(f"packed storage supports bitlevel 1 or 2, got "
                             f"{bitlevel}")
        self.rows_left = len(words)
        self.row_bytes = row_bytes(size, bitlevel)
        blob = "\n".join(words).encode("utf-8", errors="surrogateescape")
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(_HEADER.pack(len(words), size, bitlevel, len(blob)))
        self._f.write(blob)

    def write_payload(self, payload: np.ndarray) -> None:
        """uint8 [R, row_bytes] packed rows, the next R of the file."""
        payload = np.ascontiguousarray(payload, dtype=np.uint8)
        if payload.ndim != 2 or payload.shape[1] != self.row_bytes:
            raise ValueError(f"payload {payload.shape} is not [R, "
                             f"{self.row_bytes}]")
        if payload.shape[0] > self.rows_left:
            raise ValueError("more rows than words")
        self.rows_left -= payload.shape[0]
        self._f.write(payload.tobytes())

    def close(self) -> None:
        self._f.close()
        if self.rows_left:
            raise ValueError(f"{self.rows_left} rows were never written")

    def __enter__(self) -> "PackedWriter":
        return self

    def __exit__(self, exc_type, *_) -> None:
        if exc_type is None:
            self.close()
        else:
            self._f.close()


def write_packed(path: str, words: List[str], vectors: np.ndarray,
                 bitlevel: int) -> None:
    v = np.ascontiguousarray(vectors, np.float32)
    _check_grid(v, bitlevel)
    with PackedWriter(path, words, v.shape[1], bitlevel) as w:
        w.write_payload(pack_codes(torch.from_numpy(v), bitlevel).numpy())


class PackedHeader(NamedTuple):
    words: List[str]
    n_rows: int
    size: int
    bitlevel: int
    payload_offset: int      # file offset of row 0's payload


def read_packed_header(path: str) -> PackedHeader:
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError("not a W2BPACK1 file")
        V, D, bitlevel, wb = _HEADER.unpack(f.read(_HEADER.size))
        words = f.read(wb).decode("utf-8", errors="surrogateescape").split("\n")
        return PackedHeader(words, V, D, bitlevel, f.tell())


def read_packed(path: str, max_words: int = 0, first_row: int = 0,
                header: PackedHeader | None = None
                ) -> Tuple[List[str], np.ndarray, int]:
    """(words, float32 vectors, bitlevel) of rows [first_row, first_row +
    max_words) (max_words 0: to the end).  Pass the file's `header`
    (read_packed_header) to read it in row blocks without decoding the
    word list again for each."""
    if header is None:
        header = read_packed_header(path)
    words, V, D, bitlevel, offset = header
    stop = V if not max_words else min(V, first_row + max_words)
    start = min(first_row, stop)
    rb = row_bytes(D, bitlevel)
    with open(path, "rb") as f:
        f.seek(offset + start * rb)
        raw = np.frombuffer(f.read((stop - start) * rb), np.uint8).reshape(
            stop - start, rb)
    bitmat = np.unpackbits(raw, axis=1, bitorder="little")
    codes = np.zeros((stop - start, D), np.uint8)
    for b in range(bitlevel):
        codes |= (bitmat[:, b::bitlevel][:, :D] << b).astype(np.uint8)
    return words[start:stop], _decode_codes(codes, bitlevel), bitlevel
