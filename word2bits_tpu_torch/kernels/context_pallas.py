"""Fused context + positive forward of the banded CBOW step.

Kernel: csrc/context.cu, a CUDA C++ kernel for sm_90a that replaces the
JAX package's TPU kernel `fused_context_pallas` (kernels/context_pallas.py,
body `_kernel`).  Per banded tile it quantizes the slab window, forms the
context sums M @ q and counts, the averages, the center scores, and the
positive gradients, and writes only what the rest of the step consumes:

  cavg       [B, D] f32   context averages        (negative phase input)
  cavge      [B, D] f32   positive gradient accumulator seed
  dv_center  [B, D] f32   center-v update rows
  af         [B]    f32   active flags (valid sentence & nonempty context)
  loss       []     f32   positive log-sigmoid loss sum

Bound on the H100 (3.35 TB/s): bytes.  At the main path (B=8192, W=8,
tile 256, D=200, bf16 rows) the kernel must read ~16 MB (window rows,
center rows, f32 masks) and write ~20 MB: ~11 us.  Its design keeps the
quantized window in shared memory and every f32 intermediate in
registers (see the source note in csrc/context.cu).

`fused_context_pallas` runs the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors, raising on anything the kernel does
not take; it never falls back.  `fused_context_pallas.launches` counts
kernel launches.  reg == 0 only, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_context_plain(uwin3, vc, Mb, valid, scalars, bitlevel: int):
    """The plain PyTorch version: same function, same signature."""
    Nt, F, D = uwin3.shape
    B = vc.shape[0]
    alpha = scalars.reshape(())
    q = quantize(uwin3.to(torch.float32), bitlevel)                # [Nt, F, D]
    mf = Mb.to(torch.float32)                                      # [Nt, tile, F]
    csum = torch.bmm(mf, q).reshape(B, D)
    cw = mf.sum(dim=2).reshape(B, 1)
    af = valid.reshape(B, 1) * (cw > 0).to(torch.float32)
    cavg = csum / torch.clamp_min(cw, 1.0)
    q_vc = quantize(vc.to(torch.float32), bitlevel)
    f_pos = (cavg * q_vc).sum(dim=1, keepdim=True)
    g_pos = (1.0 - sigmoid_lut(f_pos)) * alpha * af
    loss = (torch.log(sigmoid_exact(f_pos)) * af).sum()
    return cavg, g_pos * q_vc, g_pos * cavg, af[:, 0], loss


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/context.cu, built on first use, with its C signatures."""
    lib = load_library("context")
    lib.w2b_context_forward.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.w2b_context_forward.restype = ctypes.c_int
    lib.w2b_context_loss_slots.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.w2b_context_loss_slots.restype = ctypes.c_int
    return lib


def _launch(uwin3, vc, Mb, valid, scalars, bitlevel: int):
    Nt, F, D = uwin3.shape
    B = vc.shape[0]
    dev = uwin3.device
    for name, t in (("uwin3", uwin3), ("vc", vc), ("Mb", Mb),
                    ("valid", valid), ("scalars", scalars)):
        if t.device != dev:
            raise ValueError(f"fused_context_pallas: {name} is on {t.device}, "
                             f"uwin3 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_context_pallas: {name} must be "
                             "contiguous")
    if uwin3.dtype not in _DTYPES or vc.dtype != uwin3.dtype:
        raise ValueError("fused_context_pallas: uwin3 and vc must share one "
                         "dtype, float32 or bfloat16 (got "
                         f"{uwin3.dtype}, {vc.dtype})")
    for name, t in (("Mb", Mb), ("valid", valid), ("scalars", scalars)):
        if t.dtype != torch.float32:
            raise ValueError(f"fused_context_pallas: {name} must be float32, "
                             f"got {t.dtype}")
    if B % Nt or vc.shape != (B, D):
        raise ValueError(f"fused_context_pallas: vc {tuple(vc.shape)} does "
                         f"not match uwin3 {tuple(uwin3.shape)}")
    tile = B // Nt
    if Mb.shape != (Nt, tile, F) or valid.numel() != B or scalars.numel() != 1:
        raise ValueError("fused_context_pallas: Mb must be [Nt, tile, F], "
                         "valid [B, 1], scalars [1, 1]")
    if not 1 <= D <= 1024 or F < tile:
        raise ValueError(f"fused_context_pallas: D={D} must be in [1, 1024] "
                         f"and F={F} >= tile={tile}")
    lib = _library()
    f32 = dict(dtype=torch.float32, device=dev)
    cavg = torch.empty((B, D), **f32)
    cavge = torch.empty((B, D), **f32)
    dvc = torch.empty((B, D), **f32)
    af = torch.empty((B,), **f32)
    loss = torch.empty((lib.w2b_context_loss_slots(Nt, tile),), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.w2b_context_forward(
        uwin3.data_ptr(), vc.data_ptr(), Mb.data_ptr(), valid.data_ptr(),
        scalars.data_ptr(), cavg.data_ptr(), cavge.data_ptr(),
        dvc.data_ptr(), af.data_ptr(), loss.data_ptr(),
        Nt, F, D, tile, bitlevel, _DTYPES[uwin3.dtype], stream)
    check_launch("w2b_context_forward", err)
    fused_context_pallas.launches += 1
    return cavg, cavge, dvc, af, loss.sum()


def fused_context_pallas(uwin3, vc, Mb, valid, scalars, bitlevel: int):
    """(cavg, cavge, dv_center, af, loss_sum) for the banded fused step.

    uwin3   [Nt, F, D]    tile windows of the slab's u-half (table dtype)
    vc      [B, D]        center v-half rows (table dtype)
    Mb      [Nt, tile, F] f32 banded context masks (0/1)
    valid   [B, 1] f32    center-is-real-token flags
    scalars [1, 1] f32    alpha
    """
    if not isinstance(bitlevel, int) or bitlevel < 0:
        raise ValueError(f"bitlevel must be an int >= 0, got {bitlevel!r}")
    if uwin3.device.type == "cpu":
        return fused_context_plain(uwin3, vc, Mb, valid, scalars, bitlevel)
    if uwin3.device.type != "cuda":
        raise ValueError("fused_context_pallas runs on cpu (plain version) or "
                         f"cuda (kernel), not {uwin3.device}")
    return _launch(uwin3, vc, Mb, valid, scalars, bitlevel)


fused_context_pallas.launches = 0
