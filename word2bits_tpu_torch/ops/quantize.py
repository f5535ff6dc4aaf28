"""Virtual quantization op — the heart of Word2Bits, in PyTorch.

Reproduces the reference `quantize()` semantics exactly
(reference src/word2bits.cpp:73-108), bit-equal to the JAX package's
ops/quantize.py in float32 and bfloat16:

  bitlevel 0:  identity (full precision)
  bitlevel 1:  sign(x) / 3          (x == 0 and x == -0.0 map to +1/3:
               C `num < 0 ? -1 : 1`; no signbit/copysign here)
  bitlevel 2:  sign(x) * (0.25 if |x| <= 0.5 else 0.75)
  bitlevel 3:  0.0 for every input  (the reference hole; the config layer
               rejects bitlevel 3, but the op is faithful)
  bitlevel>=4: sign(x) * min(floor(|x|*S + 0.5), S) / S   with S = 2^(bitlevel-1)

Each step is a separate tensor op, so every intermediate rounds to the
input dtype exactly as the JAX op does (no fused multiply-add).

`quantize_ste` is the straight-through estimator: forward quantizes,
backward passes the gradient through unchanged (reference
src/word2bits.cpp:486-503 applies gradients w.r.t. the quantized values to
the full-precision store).
"""

from __future__ import annotations

import numpy as np
import torch

from word2bits_tpu_torch.ops.consts import const as _device_const


def _check_bitlevel(bitlevel) -> None:
    if not isinstance(bitlevel, int):
        raise TypeError(
            f"bitlevel must be a Python int, got {type(bitlevel).__name__}")
    if bitlevel < 0:
        raise ValueError(f"bitlevel must be >= 0, got {bitlevel}")


def quantize(x: torch.Tensor, bitlevel: int) -> torch.Tensor:
    """Quantize to 2^bitlevel discrete values. Exact reference semantics."""
    _check_bitlevel(bitlevel)
    if bitlevel == 0:
        return x

    def const(c):
        return _device_const(c, x.dtype, x.device)

    sign = torch.where(x < 0, const(-1.0), const(1.0))
    mag = torch.abs(x)
    if bitlevel == 1:
        return sign * (const(1.0) / const(3.0))
    if bitlevel == 2:
        return sign * torch.where(mag <= 0.5, const(0.25), const(0.75))
    if bitlevel == 3:
        return x * const(0.0)
    seg = float(2 ** (bitlevel - 1))
    casted = torch.floor(mag * seg + 0.5)
    casted = torch.minimum(casted, const(seg))
    return sign * (casted / const(seg))


def quantize_np(x, bitlevel: int):
    """Pure-numpy twin of quantize() for host-side tools (the vector export).
    Same reference semantics (src/word2bits.cpp:73-108)."""
    _check_bitlevel(bitlevel)
    x = np.asarray(x)
    if bitlevel == 0:
        return x
    sign = np.where(x < 0, x.dtype.type(-1.0), x.dtype.type(1.0))
    mag = np.abs(x)
    if bitlevel == 1:
        return sign * (x.dtype.type(1.0) / x.dtype.type(3.0))
    if bitlevel == 2:
        return sign * np.where(mag <= 0.5, x.dtype.type(0.25),
                               x.dtype.type(0.75))
    if bitlevel == 3:
        return x * x.dtype.type(0.0)
    seg = float(2 ** (bitlevel - 1))
    casted = np.minimum(np.floor(mag * seg + 0.5), seg)
    return (sign * (casted / x.dtype.type(seg))).astype(x.dtype)


class _QuantizeSTE(torch.autograd.Function):
    """quantize() forward, identity backward."""

    @staticmethod
    def forward(ctx, x, bitlevel):
        return quantize(x, bitlevel)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quantize_ste(x: torch.Tensor, bitlevel: int) -> torch.Tensor:
    """quantize() with a straight-through-estimator gradient (identity VJP)."""
    _check_bitlevel(bitlevel)
    return _QuantizeSTE.apply(x, bitlevel)


def quantized_storage_bits(bitlevel: int) -> int:
    """Bits per weight of the logical quantized representation (the 8x-16x
    storage compression, reference README.md:3-5)."""
    return 32 if bitlevel == 0 else bitlevel
