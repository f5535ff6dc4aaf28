"""Sigmoid variants matching the reference's two code paths.

1. Gradient path: the reference's 1000-entry lookup table over [-6, 6]
   (reference src/word2bits.cpp:614-618, indexed at :473-475 with
   `(int)((f + MAX_EXP) * (EXP_TABLE_SIZE / MAX_EXP / 2))`).  The scale is C
   *integer* division, 1000/6/2 == 83, not 83.33.  Outside [-6, 6] the
   gradient saturates to 1 (f > 6) or 0 (f < -6).  `sigmoid_lut` evaluates
   sigma at the bin's x instead of gathering from a table: same values.

2. Loss path: exact sigmoid clamped to 1 above +6 and to 1e-9 below -6
   (reference src/word2bits.cpp:67-71), used only inside log().

The CUDA kernels carry the same two functions as __device__ code
(csrc/w2b_common.cuh).
"""

from __future__ import annotations

import torch

from word2bits_tpu_torch.ops.consts import const

EXP_TABLE_SIZE = 1000  # reference src/word2bits.cpp:30
MAX_EXP = 6.0          # reference src/word2bits.cpp:31
_LUT_SCALE = 83.0      # C integer division: 1000 / 6 / 2 == 83


def _const(f: torch.Tensor, c: float) -> torch.Tensor:
    return const(c, f.dtype, f.device)


def sigmoid_lut(f: torch.Tensor) -> torch.Tensor:
    """The reference gradient-path sigmoid: expTable lookup, +-6 saturation."""
    idx = torch.floor((f + MAX_EXP) * _LUT_SCALE)  # f+6 >= 0 in-branch
    x_bin = (idx / EXP_TABLE_SIZE * 2.0 - 1.0) * MAX_EXP
    sig = torch.sigmoid(x_bin)
    return torch.where(f > MAX_EXP, _const(f, 1.0),
                       torch.where(f < -MAX_EXP, _const(f, 0.0), sig))


def sigmoid_exact(f: torch.Tensor) -> torch.Tensor:
    """The reference loss-path sigmoid: 1 above +6, 1e-9 below -6."""
    sig = torch.sigmoid(f)
    return torch.where(f > MAX_EXP, _const(f, 1.0),
                       torch.where(f < -MAX_EXP, _const(f, 1e-9), sig))
