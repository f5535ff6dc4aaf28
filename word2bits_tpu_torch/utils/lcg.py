"""Vectorized reproduction of the reference's 48-bit LCG (numpy).

The reference uses `next = next * 25214903917 + 11 (mod 2^64)` wherever it
needs randomness; uniform floats come from `(next & 0xFFFF) / 65536`
(reference src/word2bits.cpp:352,358).  Parameter init consumes this
stream sequentially from seed 1 (v table first, then u — :343-361), so the
k-th state is computed by affine skip-ahead: f^(m+n) = (A_n*A_m,
A_n*C_m + C_n).  numpy uint64 wraps mod 2^64 like the C unsigned long long.

`lcg_uniform_torch` computes the same draws on a torch device (the fused
table's init at 3.7M x 800d is 5.92G draws): torch's int64 multiply and
add wrap mod 2^64 in two's complement, which gives the uint64 bits.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from word2bits_tpu_torch import native

LCG_A = np.uint64(25214903917)
LCG_C = np.uint64(11)


def lcg_next(state: np.uint64) -> np.uint64:
    """One scalar LCG step (mod 2^64)."""
    with np.errstate(over="ignore"):
        return np.uint64(state * LCG_A + LCG_C)


def _pow_tables(max_bits: int = 64):
    """(A^(2^j), C_(2^j)) for j in [0, max_bits)."""
    As = np.empty(max_bits, dtype=np.uint64)
    Cs = np.empty(max_bits, dtype=np.uint64)
    a, c = LCG_A, LCG_C
    with np.errstate(over="ignore"):
        for j in range(max_bits):
            As[j] = a
            Cs[j] = c
            c = np.uint64(a * c + c)
            a = np.uint64(a * a)
    return As, Cs


_POW_A, _POW_C = _pow_tables()


def lcg_states_at(ks: np.ndarray, seed: int = 1) -> np.ndarray:
    """State after exactly ks[i] steps from `seed`, vectorized over ks."""
    ks = np.asarray(ks, dtype=np.uint64)
    accA = np.ones_like(ks, dtype=np.uint64)
    accC = np.zeros_like(ks, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(64):
            bit = (ks >> np.uint64(j)) & np.uint64(1)
            if not bit.any():
                if (ks >> np.uint64(j)).max() == 0:
                    break
                continue
            sel = bit.astype(bool)
            a2, c2 = _POW_A[j], _POW_C[j]
            accC[sel] = np.uint64(a2) * accC[sel] + np.uint64(c2)
            accA[sel] = np.uint64(a2) * accA[sel]
        return np.uint64(accA * np.uint64(seed) + accC)


_LANE_BITS = 16
_LANES = 1 << _LANE_BITS


def lcg_uniform_block(start_draw: int, n: int, seed: int = 1,
                      use_native: Optional[bool] = None) -> np.ndarray:
    """Values of draws [start_draw, start_draw+n) of the reference init
    stream: draw i is ((state_{i+1} & 0xFFFF) / 65536) - 0.5 in float32
    (reference src/word2bits.cpp:350-360).  The native library's threaded
    fill (`use_native` as in data/corpus.count_words), else lane-strided
    numpy: one skip-ahead for 65536 lane heads, then each row advances by
    f^65536."""
    if n <= 0:
        return np.empty(0, dtype=np.float32)
    lib = native.native_for(use_native)
    if lib is not None:
        out = lib.lcg_fill(int(start_draw), int(n), int(seed))
        if out is not None:
            return out
    if use_native:
        raise RuntimeError("native LCG fill requested but not available")
    heads = lcg_states_at(
        np.arange(start_draw + 1, start_draw + 1 + _LANES, dtype=np.uint64),
        seed=seed)
    rows = -(-n // _LANES)
    states = np.empty((rows, _LANES), dtype=np.uint64)
    aW, cW = _POW_A[_LANE_BITS], _POW_C[_LANE_BITS]
    cur = heads
    with np.errstate(over="ignore"):
        for r in range(rows):
            states[r] = cur
            if r + 1 < rows:
                cur = aW * cur + cW
    flat = states.reshape(-1)[:n]
    return ((flat & np.uint64(0xFFFF)).astype(np.float32)
            / np.float32(65536.0) - np.float32(0.5))


def lcg_values_scalar(n: int, seed: int = 1) -> np.ndarray:
    """Slow scalar-loop oracle for tests."""
    out = np.empty(n, dtype=np.float32)
    state = np.uint64(seed)
    for i in range(n):
        state = lcg_next(state)
        out[i] = (np.float32(state & np.uint64(0xFFFF)) / np.float32(65536.0)
                  - np.float32(0.5))
    return out


def _as_int64(x: int) -> int:
    """A value mod 2^64 as the int64 with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


@functools.lru_cache(maxsize=None)
def _lane_coeffs() -> np.ndarray:
    """[2, 65536] int64: (A_j, C_j) with f^j(x) = A_j*x + C_j mod 2^64."""
    A = np.ones(_LANES, dtype=np.uint64)
    C = np.zeros(_LANES, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for b in range(_LANE_BITS):   # f^(j + 2^b) = f^j o f^(2^b)
            h = 1 << b
            A[h:2 * h] = A[:h] * _POW_A[b]
            C[h:2 * h] = A[:h] * _POW_C[b] + C[:h]
    return np.stack([A, C]).view(np.int64)


def lcg_uniform_torch(start_draw: int, n: int, device, seed: int = 1
                      ) -> torch.Tensor:
    """lcg_uniform_block(start_draw, n, seed) as a float32 tensor computed
    on `device`.  State k + r*65536 + j is f^j(f^(r*65536)(state k)): the
    row heads are Python-int skip-ahead on the host, and one broadcast
    multiply-add over [rows, 65536] lanes gives every state."""
    if n <= 0:
        return torch.empty(0, dtype=torch.float32, device=device)
    rows = -(-n // _LANES)
    mask = (1 << 64) - 1
    y = int(lcg_states_at(np.asarray([start_draw + 1], np.uint64),
                          seed=seed)[0])
    aW, cW = int(_POW_A[_LANE_BITS]), int(_POW_C[_LANE_BITS])
    heads = []
    for _ in range(rows):
        heads.append(_as_int64(y))
        y = (aW * y + cW) & mask
    coeffs = torch.from_numpy(_lane_coeffs()).to(device)
    h = torch.tensor(heads, dtype=torch.int64, device=device)[:, None]
    states = (coeffs[0] * h + coeffs[1]).reshape(-1)[:n]
    return ((states & 0xFFFF).to(torch.float32) / 65536.0) - 0.5
