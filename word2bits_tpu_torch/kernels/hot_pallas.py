"""Hot-row head accumulation: the dense half of the hot/cold split.

Kernel: csrc/hot_slice.cu, a CUDA C++ kernel for sm_90a that replaces the
JAX package's TPU kernel `hot_slice_add_pallas` (kernels/hot_pallas.py,
body `_hot_kernel`; the `-hot-pallas` path).  Same function and signature:

    head      = round(table[:H] + extra)          (skipped without extra)
    table[:H] = round(head + sum_{ids[k] == h} round(rows[k]))

with `round` to the table dtype and the sum in float32; ids outside [0, H)
contribute nothing, and every head row is stored.  `extra` rounds into the
head once before the rows' sum, as the Pallas function does; the XLA twin
ops/scatter.hot_slice_add adds it in float32 and rounds once.

The TPU kernel builds one-hot tiles so that the MXU does the segmented sum;
the card needs no such mechanism.  The plan (`hot_plan`, plain PyTorch) is
one stable sort of the ids, ids outside [0, H) sent to the end, and the
start of each head row's run; it depends only on the ids, so the training
chunk builds it once for all S steps (batched over a leading dimension,
as the span plan) and passes each step's.  The kernel gives one CTA to
each head row, which sums its run in a fixed order and stores the row
once.

Bound on the H100 (3.35 TB/s): bytes — the ids, the hot rows, the head
read and written once, `extra` once (a few us at the [hot] path's 8,208
rows into a 2048 x 400 bf16 head); the time is in PERF.md.

`hot_slice_add_pallas` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors, raising on what it does not take; there is no
fallback.  `hot_slice_add_pallas.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.ops.scatter import hot_slice_add

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class HotPlan(NamedTuple):
    """Pure function of (ids, H); leading dimensions batch S steps."""

    order: torch.Tensor    # [..., N] int32 rows sorted by head id, the
    #                        others last
    starts: torch.Tensor   # [..., H+1] int32 start of each head row's run

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
    return HotPlan(order=order.to(torch.int32), starts=starts.to(torch.int32))


def hot_slice_add_plain(table: torch.Tensor, ids: torch.Tensor,
                        rows: torch.Tensor, hot_rows: int,
                        extra: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain PyTorch version, in place: `extra` rounds into the head
    first, then ops/scatter.hot_slice_add adds the rows' float32 sums."""
    H = int(hot_rows)
    if extra is not None:
        table[:H] = (table[:H].to(torch.float32)
                     + extra.to(torch.float32)).to(table.dtype)
    return hot_slice_add(table, ids, rows, H)


@functools.lru_cache(maxsize=None)
def _kernel():
    """w2b_hot_slice of csrc/hot_slice.cu, built on first use."""
    fn = load_library("hot_slice").w2b_hot_slice
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(table, ids, rows, H: int, extra, plan: Optional[HotPlan]):
    fn = "hot_slice_add_pallas"
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
    if plan is None:
        plan = hot_plan(ids, H)
    for name, t, n in (("order", plan.order, ids.shape[0]),
                       ("starts", plan.starts, H + 1)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (n,)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{fn}: plan.{name} must be one step's "
                             f"contiguous int32 [{n}] on {dev}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        table.data_ptr(), rows.data_ptr(),
        None if extra is None else extra.data_ptr(),
        plan.order.data_ptr(), plan.starts.data_ptr(), H, C,
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
