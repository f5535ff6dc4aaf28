"""Hot-row head accumulation: the dense half of the hot/cold split.

Kernel: csrc/hot_slice.cu, a CUDA C++ kernel for sm_90a that replaces the
JAX package's TPU kernel `hot_slice_add_pallas` (kernels/hot_pallas.py,
body `_hot_kernel`; the `-hot-pallas` path).  Same function and signature:

    head      = round(table[:H] + extra)          (skipped without extra)
    table[:H] = round(head + sum_{ids[k] == h} round(rows[k]))

with `round` to the table dtype and the sum in float32; ids outside [0, H)
contribute nothing; with `extra` every head row is stored, without it a
head row that no row reaches keeps its value.  `extra` rounds into the
head once before the rows' sum, as the Pallas function does; the XLA twin
ops/scatter.hot_slice_add adds it in float32 and rounds once.

The TPU kernel builds one-hot tiles so that the MXU does the segmented sum;
the card needs no such mechanism.  The plan (`hot_plan`, plain PyTorch) is
one stable sort of the ids keyed H outside [0, H): the sorted keys
(`sids`), their source rows (`order`) and the start of each head row's run
(`starts`).  It depends only on the ids, so the training chunk builds it
once for all S steps (batched over a leading dimension, as the sort plan)
and passes each step's.  The kernel is the tiled sorted scatter-add of
csrc/w2b_tiles.cuh (kernels 2, 3, 7 and 8 run it too) on `sids` and
`order` with V = H, so the cold key drops out like any id outside [0, V):
tiles of the sorted stream and groups of columns, one CTA each, all at
once; a run cut by tile edges (the Zipf head) summed piece by piece into
float32 partials of the per-device workspace (`span_scatter.workspace`)
and added in tile order.  Its HeadFold epilogue folds `extra` into each
touched head row in that row's one read-modify-write; with `extra`,
further CTAs fold the head rows that no row reaches (read from
`starts`).  The earlier design gave one CTA to each head row (2,048 CTAs
for ~5,470 hot rows, most with a run of 0-3 rows, each paying a chain of
dependent loads; the longest run summed by one CTA): 2.5x its bound.

Bound on the H100 (3.35 TB/s): bytes — the ids, the hot rows, the head
read and written once, `extra` once (a few us at the [hot] path's 8,208
rows into a 2048 x 400 bf16 head); the time is in PERF.md.

`hot_slice_add_pallas` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors, raising on what it does not take; there is no
fallback.  Its launches share the workspace of kernels 2, 3, 7 and 8, so
two calls must not run at once on different streams; no path of the port
does that.  `hot_slice_add_pallas.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.kernels.span_scatter import (tile_constants,
                                                      workspace)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class HotPlan(NamedTuple):
    """Pure function of (ids, H); leading dimensions batch S steps."""

    order: torch.Tensor    # [..., N] int32 rows sorted by head id, the
    #                        others last
    starts: torch.Tensor   # [..., H+1] int32 start of each head row's run
    sids: torch.Tensor     # [..., N] int32 the sorted keys: the id in
    #                        [0, H), else H

    def step(self, s: int) -> "HotPlan":
        """The plan of step s of a batched plan."""
        return HotPlan(*(a[s] for a in self))


def hot_plan(ids: torch.Tensor, hot_rows: int) -> HotPlan:
    """The segmented-sum plan of `ids` ([..., N]) for the head
    [0, hot_rows)."""
    H = int(hot_rows)
    key = torch.where((ids >= 0) & (ids < H), ids, H)
    skey, order = torch.sort(key, dim=-1, stable=True)
    heads = torch.arange(H + 1, dtype=skey.dtype, device=ids.device)
    starts = torch.searchsorted(
        skey, heads.expand(ids.shape[:-1] + (H + 1,)).contiguous())
    i32 = torch.int32
    return HotPlan(order=order.to(i32), starts=starts.to(i32),
                   sids=skey.to(i32))


def hot_slice_add_plain(table: torch.Tensor, ids: torch.Tensor,
                        rows: torch.Tensor, hot_rows: int,
                        extra: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain PyTorch version, in place: `extra` rounds into the head
    first, then the rows' float32 sums (an index_add_ into a float32
    [H, C] buffer, the sums of ops/scatter.hot_slice_add) are added with
    one rounding."""
    H = int(hot_rows)
    if extra is not None:
        table[:H] = (table[:H].to(torch.float32)
                     + extra.to(torch.float32)).to(table.dtype)
    H = min(H, table.shape[0])
    mm_dtype = torch.bfloat16 if table.dtype == torch.bfloat16 else rows.dtype
    hot = (ids >= 0) & (ids < H)
    acc = torch.zeros((H, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    acc.index_add_(0, torch.where(hot, ids, 0),
                   torch.where(hot[:, None], rows.to(mm_dtype), 0)
                   .to(torch.float32))
    table[:H] = (table[:H].to(torch.float32) + acc).to(table.dtype)
    return table


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/hot_slice.cu, built on first use, with its C signatures."""
    lib = load_library("hot_slice")
    lib.w2b_hot_slice.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                  + [ctypes.c_void_p])
    lib.w2b_hot_slice.restype = ctypes.c_int
    for fn in (lib.w2b_hot_slice_partials, lib.w2b_hot_slice_counters):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_longlong
    lib.w2b_hot_slice_config.argtypes = [ctypes.c_void_p]
    return lib


def tile_config() -> dict:
    """The kernel's tile constants, as built."""
    return tile_constants(_library().w2b_hot_slice_config)


def _check(fn: str, table, ids, rows, H: int, extra, plan: HotPlan) -> None:
    """Raise on anything the kernel does not take; `fn` names the caller
    in errors."""
    V, C = table.shape
    dev = table.device
    if table.dtype not in _DTYPES:
        raise ValueError(f"{fn}: table dtype {table.dtype} is not float32 "
                         "or bfloat16")
    if rows.dtype not in (torch.float32, table.dtype):
        raise ValueError(f"{fn}: rows must be float32 or {table.dtype}, got "
                         f"{rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] != C or ids.shape != rows.shape[:1]:
        raise ValueError(f"{fn}: ids {tuple(ids.shape)} and rows "
                         f"{tuple(rows.shape)} vs a table of width {C}")
    if not 0 <= H <= V:
        raise ValueError(f"{fn}: hot_rows {H} outside [0, {V}]")
    tensors = [("table", table), ("ids", ids), ("rows", rows)]
    if extra is not None:
        if extra.dtype != torch.float32 or tuple(extra.shape) != (H, C):
            raise ValueError(f"{fn}: extra must be float32 ({H}, {C}), got "
                             f"{extra.dtype} {tuple(extra.shape)}")
        tensors.append(("extra", extra))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, table on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    N = ids.shape[0]
    for name, n in (("order", N), ("starts", H + 1), ("sids", N)):
        t = getattr(plan, name)
        if (t.dtype != torch.int32 or tuple(t.shape) != (n,)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{fn}: plan.{name} must be one step's "
                             f"contiguous int32 [{n}] on {dev}")


def _launch(table, ids, rows, H: int, extra, plan: Optional[HotPlan]):
    fn = "hot_slice_add_pallas"
    if plan is None:
        plan = hot_plan(ids, H)
    _check(fn, table, ids, rows, H, extra, plan)
    C = table.shape[1]
    N = ids.shape[0]
    lib = _library()
    part, count = workspace(table.device, lib.w2b_hot_slice_partials(N, C),
                            lib.w2b_hot_slice_counters(N, C))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.w2b_hot_slice(
        table.data_ptr(), rows.data_ptr(),
        None if extra is None else extra.data_ptr(),
        plan.sids.data_ptr(), plan.order.data_ptr(), plan.starts.data_ptr(),
        part.data_ptr(), count.data_ptr(), N, H, C,
        _DTYPES[table.dtype], _DTYPES[rows.dtype], stream)
    check_launch("w2b_hot_slice", err)
    hot_slice_add_pallas.launches += 1
    return table


def hot_slice_add_pallas(table: torch.Tensor, ids: torch.Tensor,
                         rows: torch.Tensor, hot_rows: int,
                         extra: Optional[torch.Tensor] = None,
                         block_h: int = 512, block_n: int = 512,
                         plan: Optional[HotPlan] = None) -> torch.Tensor:
    """table[:H] += the float32 sums of the rows whose id is in [0, H),
    after `extra` rounds into the head; in place.  table [V, C]; ids [N];
    rows [N, C] in float32 or the table dtype; extra optional [H, C]
    float32; `plan` optional, this step's hot_plan of the ids (built here
    without it).  `block_h` and `block_n` size the TPU kernel's tiles and
    have no role on the card."""
    if table.device.type == "cpu":
        return hot_slice_add_plain(table, ids, rows, hot_rows, extra)
    if table.device.type != "cuda":
        raise ValueError("hot_slice_add_pallas runs on cpu (plain version) "
                         f"or cuda (kernel), not {table.device}")
    return _launch(table, ids, rows, int(hot_rows), extra, plan)


hot_slice_add_pallas.launches = 0
