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
center rows, f32 masks) and write ~20 MB: ~11 us; at the capacity path's
D=800, B=16384, 229 MB: 68 us.  One CTA owns whole rows of 16 centers of a
tile: it reads their mask rows once into bit words (warp ballots), stages
only the window rows those bits reach, quantized once, in shared memory,
sums the set columns in ascending order, and writes each output once
(float4 stores).  A mask with ones outside the band is still exact: the
span is staged in pieces.  The first design (one thread per column, the
whole band multiplied) took 1.78 ms at D=800 and 0.182 ms at D=200 (NVIDIA
H100 80GB HBM3, 700 W; PERF.md, which has the redesign's times); the source
note in csrc/context.cu has the details.

`fused_context_pallas` takes the rows materialized: the slab's tile
windows and the centers' v rows.  `fused_context_rows` takes them in their
tables, read by the slab's ids inside the kernel (csrc/context.cu
TableRows), so the step gathers and copies nothing for it; the outputs are
the dense call's on the same rows, bit for bit.  Both run the plain PyTorch
version for CPU tensors and launch the kernel for CUDA tensors, raising on
anything the kernel does not take; they never fall back.
`fused_context_pallas.launches` counts every launch of the kernel,
`fused_context_rows.launches` those of the by-id entry.  reg == 0 only, as
in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.ops.windowed import _tile_windows

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


def fused_context_rows_plain(u_tab, v_tab, slab_ids, Mb, valid, scalars,
                             bitlevel: int):
    """The by-id entry's plain version: the slab's rows gathered (ids
    clamped into [0, V), as the kernel reads them), cut into tile windows,
    and fused_context_plain."""
    Nt, tile, F = Mb.shape
    W = (F - tile) // 2
    ids = slab_ids.clamp(0, u_tab.shape[0] - 1)
    return fused_context_plain(_tile_windows(u_tab[ids], Nt, tile, W),
                               v_tab[ids[W:W + Nt * tile]], Mb, valid,
                               scalars, bitlevel)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/context.cu, built on first use, with its C signatures."""
    lib = load_library("context")
    lib.w2b_context_forward.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.w2b_context_forward.restype = ctypes.c_int
    lib.w2b_context_forward_rows.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    lib.w2b_context_forward_rows.restype = ctypes.c_int
    lib.w2b_context_loss_slots.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.w2b_context_loss_slots.restype = ctypes.c_int
    return lib


def _check_common(fn: str, dev, dtype, Mb, valid, scalars, B: int, D: int):
    """The masks, flags and alpha of either entry, on `dev`; the rows'
    dtype and width."""
    for name, t in (("Mb", Mb), ("valid", valid), ("scalars", scalars)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, the rows on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
    if dtype not in _DTYPES:
        raise ValueError(f"{fn}: the rows must be float32 or bfloat16, got "
                         f"{dtype}")
    if Mb.dim() != 3 or valid.numel() != B or scalars.numel() != 1:
        raise ValueError(f"{fn}: Mb must be [Nt, tile, F], valid [B, 1], "
                         "scalars [1, 1]")
    Nt, tile, F = Mb.shape
    if not 1 <= D <= 1024 or F < tile:
        raise ValueError(f"{fn}: D={D} must be in [1, 1024] and F={F} >= "
                         f"tile={tile}")


def _run(launch, dev, Nt: int, tile: int, B: int, D: int):
    """Allocate the outputs, launch (launch(lib, output pointers, stream)
    launches and checks), count; (cavg, cavge, dv_center, af, loss_sum)."""
    lib = _library()
    f32 = dict(dtype=torch.float32, device=dev)
    cavg = torch.empty((B, D), **f32)
    cavge = torch.empty((B, D), **f32)
    dvc = torch.empty((B, D), **f32)
    af = torch.empty((B,), **f32)
    loss = torch.empty((lib.w2b_context_loss_slots(Nt, tile),), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch(lib, [t.data_ptr() for t in (cavg, cavge, dvc, af, loss)], stream)
    fused_context_pallas.launches += 1
    return cavg, cavge, dvc, af, loss.sum()


def _launch(uwin3, vc, Mb, valid, scalars, bitlevel: int):
    Nt, F, D = uwin3.shape
    B = vc.shape[0]
    dev = uwin3.device
    for name, t in (("uwin3", uwin3), ("vc", vc)):
        if t.device != dev:
            raise ValueError(f"fused_context_pallas: {name} is on {t.device}, "
                             f"uwin3 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_context_pallas: {name} must be "
                             "contiguous")
    if vc.dtype != uwin3.dtype:
        raise ValueError("fused_context_pallas: uwin3 and vc must share one "
                         f"dtype (got {uwin3.dtype}, {vc.dtype})")
    _check_common("fused_context_pallas", dev, uwin3.dtype, Mb, valid,
                  scalars, B, D)
    if B % Nt or vc.shape != (B, D) or Mb.shape != (Nt, B // Nt, F):
        raise ValueError(f"fused_context_pallas: vc {tuple(vc.shape)} and Mb "
                         f"{tuple(Mb.shape)} do not match uwin3 "
                         f"{tuple(uwin3.shape)}")
    tile = B // Nt

    def launch(lib, out, stream):
        err = lib.w2b_context_forward(
            uwin3.data_ptr(), vc.data_ptr(), Mb.data_ptr(), valid.data_ptr(),
            scalars.data_ptr(), *out, Nt, F, D, tile, bitlevel,
            _DTYPES[uwin3.dtype], stream)
        check_launch("w2b_context_forward", err)

    return _run(launch, dev, Nt, tile, B, D)


def _launch_rows(u_tab, v_tab, slab_ids, Mb, valid, scalars, bitlevel: int):
    fn = "fused_context_rows"
    if Mb.dim() != 3:
        raise ValueError(f"{fn}: Mb must be [Nt, tile, F]")
    dev = u_tab.device
    Nt, tile, F = Mb.shape
    B, D = Nt * tile, u_tab.shape[-1]
    for name, t in (("u_tab", u_tab), ("v_tab", v_tab)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, u_tab on {dev}")
        if t.dim() != 2 or t.shape != u_tab.shape or t.stride(1) != 1:
            raise ValueError(f"{fn}: u_tab and v_tab must be [V, D] with "
                             f"unit column stride (got {tuple(u_tab.shape)} "
                             f"{u_tab.stride()}, {tuple(v_tab.shape)} "
                             f"{v_tab.stride()})")
    if v_tab.dtype != u_tab.dtype:
        raise ValueError(f"{fn}: u_tab and v_tab must share one dtype (got "
                         f"{u_tab.dtype}, {v_tab.dtype})")
    _check_common(fn, dev, u_tab.dtype, Mb, valid, scalars, B, D)
    if (F - tile) % 2:
        raise ValueError(f"{fn}: F - tile = {F - tile} must be 2W")
    if (slab_ids.device != dev
            or slab_ids.dtype not in (torch.int32, torch.int64)
            or not slab_ids.is_contiguous()
            or slab_ids.shape != (B + F - tile,)):
        raise ValueError(f"{fn}: slab_ids must be contiguous int32 or int64 "
                         f"[B + 2W = {B + F - tile}] on {dev} (got "
                         f"{tuple(slab_ids.shape)} {slab_ids.dtype} on "
                         f"{slab_ids.device})")
    V = u_tab.shape[0]
    if not 1 <= V < 2 ** 31:
        raise ValueError(f"{fn}: {V} rows (1 to 2^31 - 1 taken)")

    def launch(lib, out, stream):
        err = lib.w2b_context_forward_rows(
            u_tab.data_ptr(), v_tab.data_ptr(), u_tab.stride(0),
            v_tab.stride(0), slab_ids.data_ptr(), slab_ids.element_size(),
            V, Mb.data_ptr(),
            valid.data_ptr(), scalars.data_ptr(), *out, Nt, F, D, tile,
            bitlevel, _DTYPES[u_tab.dtype], stream)
        check_launch("w2b_context_forward_rows", err)

    got = _run(launch, dev, Nt, tile, B, D)
    fused_context_rows.launches += 1
    return got


def _check_bitlevel(bitlevel) -> None:
    if not isinstance(bitlevel, int) or bitlevel < 0:
        raise ValueError(f"bitlevel must be an int >= 0, got {bitlevel!r}")


def fused_context_pallas(uwin3, vc, Mb, valid, scalars, bitlevel: int):
    """(cavg, cavge, dv_center, af, loss_sum) for the banded fused step.

    uwin3   [Nt, F, D]    tile windows of the slab's u-half (table dtype)
    vc      [B, D]        center v-half rows (table dtype)
    Mb      [Nt, tile, F] f32 banded context masks (0/1)
    valid   [B, 1] f32    center-is-real-token flags
    scalars [1, 1] f32    alpha
    """
    _check_bitlevel(bitlevel)
    if uwin3.device.type == "cpu":
        return fused_context_plain(uwin3, vc, Mb, valid, scalars, bitlevel)
    if uwin3.device.type != "cuda":
        raise ValueError("fused_context_pallas runs on cpu (plain version) or "
                         f"cuda (kernel), not {uwin3.device}")
    return _launch(uwin3, vc, Mb, valid, scalars, bitlevel)


fused_context_pallas.launches = 0


def fused_context_rows(u_tab, v_tab, slab_ids, Mb, valid, scalars,
                       bitlevel: int):
    """fused_context_pallas's outputs from the rows in their tables.

    u_tab    [V, D]        the u table (table dtype; unit column stride)
    v_tab    [V, D]        the v table: the fused table's halves
                           table[:, :D] and table[:, D:], or split tables
    slab_ids [B + 2W]      int32 or int64 ids of the slab (contiguous;
                           clamped into [0, V)): window row p of tile t is
                           u_tab[slab_ids[t * tile + p]], center b's v row
                           v_tab[slab_ids[W + b]]
    Mb, valid, scalars     as fused_context_pallas's
    """
    _check_bitlevel(bitlevel)
    if u_tab.device.type == "cpu":
        return fused_context_rows_plain(u_tab, v_tab, slab_ids, Mb, valid,
                                        scalars, bitlevel)
    if u_tab.device.type != "cuda":
        raise ValueError("fused_context_rows runs on cpu (plain version) or "
                         f"cuda (kernel), not {u_tab.device}")
    return _launch_rows(u_tab, v_tab, slab_ids, Mb, valid, scalars, bitlevel)


fused_context_rows.launches = 0
