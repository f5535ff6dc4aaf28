"""Elementwise quantize of a 2-D array: the pass the export (train.
write_output), `cli convert` and `cli nearest` run where quantization IS
the operation (3.7M x 800 export sums, re-quantized loaded vectors).

Kernel: csrc/quantize.cu, a CUDA C++ kernel for sm_90a that replaces the
JAX package's TPU kernel (kernels/quantize_pallas.py, `_quantize_kernel`
via `quantize_pallas`).  It returns a new array of the input's shape and
dtype (float32 or bfloat16), bit-equal to ops/quantize.quantize: in
bfloat16 every intermediate rounds to bfloat16, as the JAX op rounds it.
Every bitlevel launches the kernel, 0 (a copy) and the bitlevel-3 hole
(x * 0) included, as the Pallas call does.  `block_rows` sizes the TPU
kernel's VMEM tiles and has no role on the card (the kernel streams the
flat array in 16-byte accesses); it is kept for the signature.

Bound on the H100 (3.35 TB/s): bytes, the input read once and the output
written once; the time is in PERF.md.

`quantize_pallas` runs the plain version (quantize_pallas_plain) for CPU
tensors and launches the kernel for CUDA tensors, raising on what it does
not take; there is no fallback.  `quantize_pallas.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.ops.quantize import _check_bitlevel, quantize

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# seg = 2^(bitlevel-1) must stay a finite power of two in float32
MAX_BITLEVEL = 126


def quantize_pallas_plain(x: torch.Tensor, bitlevel: int) -> torch.Tensor:
    """The plain PyTorch version: ops/quantize.quantize, into a new
    tensor (bitlevel 0 copies)."""
    out = quantize(x, bitlevel)
    return out.clone() if out is x else out


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("quantize").w2b_quantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_pallas(x: torch.Tensor, bitlevel: int,
                    block_rows: int = 512) -> torch.Tensor:
    """quantize(x, bitlevel) of a 2-D float32 or bfloat16 tensor, into a
    new tensor of the same shape and dtype."""
    if x.dim() != 2:
        raise ValueError("quantize_pallas expects a 2D array")
    _check_bitlevel(bitlevel)
    if block_rows <= 0:
        raise ValueError(f"quantize_pallas: block_rows must be positive, "
                         f"got {block_rows}")
    if x.device.type == "cpu":
        return quantize_pallas_plain(x, bitlevel)
    if x.device.type != "cuda":
        raise ValueError("quantize_pallas runs on cpu (plain version) or "
                         f"cuda (kernel), not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_pallas: dtype {x.dtype} is not float32 "
                         "or bfloat16")
    if bitlevel > MAX_BITLEVEL:
        raise ValueError(f"quantize_pallas: bitlevel {bitlevel} > "
                         f"{MAX_BITLEVEL} (2^(bitlevel-1) overflows float32)")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), out.data_ptr(), x.numel(), bitlevel,
                    _DTYPES[x.dtype], stream)
    check_launch("w2b_quantize", err)
    quantize_pallas.launches += 1
    return out


quantize_pallas.launches = 0
