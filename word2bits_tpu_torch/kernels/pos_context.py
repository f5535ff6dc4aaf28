"""Position-weighted context of fastText's CBOW with position weights
(`-model fasttext-cbow`, models/subword_cbow.py; Mikolov et al. 2018,
arXiv 1712.09405, §2.2): the forward sum over a slab step's window and its
transpose.

Kernel: csrc/pos_context.cu, a CUDA C++ kernel for sm_90a, row 12 of
PERF.md's table.  It replaces no TPU kernel (the JAX package has no such
model); the banded u-sum (kernel 10) takes one scalar weight a band, not a
D-vector a position.  With the offsets o_p = -W..-1, 1..W of the window's
2W positions p:

  h  [B, D]      h[b]  = (sum_p m[b,p] * (d[p] * x[W+b+o_p])) / max(n_b, 1)
  dx [B+2W, D]   dx[s] = sum_p m[b,p] * (d[p] * e[b]),  b = s - W - o_p
  dd [2W, D]     dd[p] = sum_b m[b,p] * (e[b] * x[W+b+o_p])

x [B+2W, D] holds the slab words' input vectors, d [2W, D] the position
weights, m [B, 2W] the masks (0 or 1), n_b = sum_p m[b,p], and e [B, D]
the gradient of h, added undivided (the word2vec convention).  Bound on
the H100 (3.35 TB/s): bytes; the source note in csrc/pos_context.cu has
the design.

`pos_context` and `pos_context_grad` run the plain PyTorch versions for
CPU tensors and launch the kernel for CUDA tensors; they never fall back.
h and dx are the plain versions' bits (the same products added in the same
order); dd is summed in a fixed order of its own, within float32 rounding
of the plain version's.  `pos_context.launches` counts the launches of
both entries: two a step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.kernels.span_scatter import workspace


def _offsets(W: int):
    return [o for o in range(-W, W + 1) if o != 0]


def pos_context_plain(x: torch.Tensor, d: torch.Tensor, m: torch.Tensor,
                      W: int) -> torch.Tensor:
    """The plain PyTorch version of the forward: h [B, D]."""
    B = m.shape[0]
    acc = torch.zeros((B, x.shape[1]), dtype=torch.float32, device=x.device)
    for p, o in enumerate(_offsets(W)):
        acc = acc + m[:, p, None] * (d[p] * x[W + o:W + o + B])
    return acc / m.sum(dim=1).clamp_min(1.0)[:, None]


def pos_context_grad_plain(e: torch.Tensor, x: torch.Tensor,
                           d: torch.Tensor, m: torch.Tensor,
                           W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward: (dx [B+2W, D],
    dd [2W, D])."""
    B = m.shape[0]
    dx = torch.zeros_like(x)
    dd = torch.empty_like(d)
    for p, o in enumerate(_offsets(W)):
        dx[W + o:W + o + B] += m[:, p, None] * (d[p] * e)
        dd[p] = (m[:, p, None] * (e * x[W + o:W + o + B])).sum(dim=0)
    return dx, dd


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/pos_context.cu, built on first use, with its C signatures."""
    lib = load_library("pos_context")
    lib.w2b_pos_context.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.w2b_pos_context.restype = ctypes.c_int
    lib.w2b_pos_context_grad.argtypes = ([ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 3
                                         + [ctypes.c_void_p])
    lib.w2b_pos_context_grad.restype = ctypes.c_int
    lib.w2b_pos_context_tile.argtypes = [ctypes.c_void_p]
    lib.w2b_pos_context_tile.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def tile() -> Tuple[int, int]:
    """The backward's (slab rows a chunk, columns a group)."""
    out = (ctypes.c_int * 2)()
    _library().w2b_pos_context_tile(out)
    return out[0], out[1]


def _check(fn: str, W: int, **named) -> None:
    m = named["m"]
    dev = m.device
    if W < 1 or m.dim() != 2 or m.shape[1] != 2 * W:
        raise ValueError(f"{fn}: m must be [B, 2W] with W = {W} >= 1, got "
                         f"{tuple(m.shape)}")
    B = m.shape[0]
    D = named["x"].shape[-1]
    want = {"x": (B + 2 * W, D), "d": (2 * W, D), "m": (B, 2 * W),
            "e": (B, D)}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, m on {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous float32, got "
                             f"{t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{fn}: {name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cpu (plain version) or cuda "
                         f"(kernel), not {dev}")


def pos_context(x: torch.Tensor, d: torch.Tensor, m: torch.Tensor,
                W: int) -> torch.Tensor:
    """h [B, D] float32 of the slab words' vectors x [B+2W, D], the
    position weights d [2W, D] and the masks m [B, 2W]."""
    _check("pos_context", W, x=x, d=d, m=m)
    if x.device.type == "cpu":
        return pos_context_plain(x, d, m, W)
    B, D = m.shape[0], x.shape[1]
    h = torch.empty((B, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().w2b_pos_context(x.data_ptr(), d.data_ptr(), m.data_ptr(),
                                     h.data_ptr(), B, D, W, stream)
    check_launch("w2b_pos_context", err)
    pos_context.launches += 1
    return h


def pos_context_grad(e: torch.Tensor, x: torch.Tensor, d: torch.Tensor,
                     m: torch.Tensor,
                     W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx [B+2W, D], dd [2W, D]) float32: the gradient e [B, D] of h taken
    back to the slab rows and to the position weights."""
    _check("pos_context_grad", W, e=e, x=x, d=d, m=m)
    if x.device.type == "cpu":
        return pos_context_grad_plain(e, x, d, m, W)
    B, D = m.shape[0], x.shape[1]
    ch, group = tile()
    chunks = -(-(B + 2 * W) // ch)
    # the chunks' partials of dd and one arrival counter a column group,
    # in the tiled kernels' workspace (each launch leaves it zero)
    part, count = workspace(x.device, chunks * 2 * W * D, -(-D // group))
    dx = torch.empty_like(x)
    dd = torch.empty_like(d)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().w2b_pos_context_grad(
        e.data_ptr(), x.data_ptr(), d.data_ptr(), m.data_ptr(), dx.data_ptr(),
        dd.data_ptr(), part.data_ptr(), count.data_ptr(), B, D, W, stream)
    check_launch("w2b_pos_context_grad", err)
    pos_context.launches += 1
    return dx, dd


pos_context.launches = 0
