"""Banded u-sum of the CBOW step: each slab row's sum over the centers
whose window holds it.

Kernel: csrc/band_usum.cu, a CUDA C++ kernel for sm_90a.  It replaces no
TPU kernel: the JAX package leaves this sum to XLA as a dense batched
product (ops/windowed.banded_usum), which on the card ran as a float32
GEMM over the whole [tile, tile + 2W] mask of each tile, 17x the
operations the band needs, with a mask product, a clone and a
concatenation around it.  The kernel reads only each mask row's band and
writes each output row once:

  du_slab [B+2W, D] f32   du[p]  = sum_b M[b, p] * af[b] * cavge[b]
  cnt     [B+2W]    f32   cnt[p] = sum_b M[b, p] * af[b]   (with_cnt)

over the centers b in [p - 2W, p], where M[b, p] is the mask entry of
center b's tile at slab row p.  Bound on the H100 (3.35 TB/s): bytes,
cavge read once and du_slab written once: 106 MB, 31.7 us at B = 16384,
D = 800, W = 8; 13.7 MB, 4.1 us at B = 8192, D = 200.  The source note in
csrc/band_usum.cu has the design.

The mask's contract: each center row i of a tile is zero outside the band
of columns [i, i + 2W], as ops/windowed.build_banded_masks builds it (a
context lies within W of its center).  The kernel reads only the band; the
plain version reads the whole mask.

`band_usum` runs the plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back.  `band_usum.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.ops.windowed import banded_usum


def band_usum_plain(Mb, af, cavge, W: int, with_cnt: bool):
    """The plain PyTorch version: the dense batched product of
    ops/windowed.banded_usum on the mask weighted by af."""
    Nt, tile, _ = Mb.shape
    du_slab, cnt = banded_usum(Mb * af.reshape(Nt, tile)[:, :, None], cavge,
                               Nt * tile, W)
    return du_slab, (cnt if with_cnt else None)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/band_usum.cu, built on first use, with its C signatures."""
    lib = load_library("band_usum")
    lib.w2b_band_usum.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.w2b_band_usum.restype = ctypes.c_int
    lib.w2b_band_usum_launch_shape.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.w2b_band_usum_launch_shape.restype = ctypes.c_int
    return lib


def _check(Mb, af, cavge, W: int) -> None:
    dev = cavge.device
    for name, t in (("Mb", Mb), ("af", af), ("cavge", cavge)):
        if t.device != dev:
            raise ValueError(f"band_usum: {name} is on {t.device}, cavge on "
                             f"{dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"band_usum: {name} must be float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"band_usum: {name} must be contiguous")
    if Mb.dim() != 3 or cavge.dim() != 2:
        raise ValueError("band_usum: Mb must be [B/tile, tile, tile + 2W] and "
                         "cavge [B, D]")
    Nt, tile, F = Mb.shape
    B = Nt * tile
    if W < 0 or tile < 2 * W:
        raise ValueError(f"band_usum: tile {tile} must be >= 2W = {2 * W}")
    if F != tile + 2 * W or cavge.shape[0] != B or af.shape != (B,):
        raise ValueError(f"band_usum: Mb {tuple(Mb.shape)} must be [B/tile, "
                         f"tile, tile + 2W] with W = {W}, af [B] and cavge "
                         f"[B, D] (got af {tuple(af.shape)}, cavge "
                         f"{tuple(cavge.shape)})")


def band_usum(Mb, af, cavge, W: int, with_cnt: bool):
    """(du_slab [B+2W, D] f32, cnt [B+2W] f32 or None) of the banded step.

    Mb     [B/tile, tile, tile+2W] f32 banded masks (0 outside the band)
    af     [B] f32                 active centers
    cavge  [B, D] f32              the centers' u-gradient rows
    """
    _check(Mb, af, cavge, W)
    if cavge.device.type == "cpu":
        return band_usum_plain(Mb, af, cavge, W, with_cnt)
    if cavge.device.type != "cuda":
        raise ValueError("band_usum runs on cpu (plain version) or cuda "
                         f"(kernel), not {cavge.device}")
    Nt, tile, _ = Mb.shape
    B, D = cavge.shape
    f32 = dict(dtype=torch.float32, device=cavge.device)
    du_slab = torch.empty((B + 2 * W, D), **f32)
    cnt = torch.empty((B + 2 * W,), **f32) if with_cnt else None
    stream = torch.cuda.current_stream(cavge.device).cuda_stream
    err = _library().w2b_band_usum(
        Mb.data_ptr(), af.data_ptr(), cavge.data_ptr(), du_slab.data_ptr(),
        None if cnt is None else cnt.data_ptr(), B, D, W, tile, stream)
    check_launch("w2b_band_usum", err)
    band_usum.launches += 1
    return du_slab, cnt


band_usum.launches = 0
